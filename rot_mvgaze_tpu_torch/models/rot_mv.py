"""Rotation-constrained cross-view gaze fusion model: port of
``rot_mvgaze_tpu/models/rot_mv.py``, every path, in train and eval mode.

input  : {img_0, img_1 (N,H,W,3) float, rot_0, rot_1 (N,3,3)}
output : input ∪ {num_iter, img_feat_{0,1}, initial_rot_feat_{0,1},
                  iter_{i}: {feat_0, feat_1, pred_gaze_0, pred_gaze_1},
                  pred_gaze}

Per iteration i (the default path)::

    rot_10 = R0 @ R1^T ;  rot_01 = R1 @ R0^T          (float32)
    f0' = fuser_i(img_feat_0, rot_10 @ f1)
    f1' = fuser_i(img_feat_1, rot_01 @ f0)            # uses PRE-update f0
    g0  = head_i([img_feat_0, f0'])
    g1  = head_i([img_feat_1, f1'])

The ablations change the fuser: ``ignore_rotmat`` fuses the unrotated
partner, ``encode_rotmat`` concatenates the raw relative rotation to the
unrotated partner (:class:`ImageRotmatFeatFuser`), ``share_feature`` fuses
both views' intensity-normalised rotatable features (:class:`RotFeatFuser`)
and feeds the head ``[f_init, f']`` interleaved per row. The module tree
carries the reference checkpoints' names (``_feat_extractor.0``,
``_lifter._lifter``, ``_img_fusers.{i}._fuser``,
``_img_fusers.{i}._batchnorm``, ``_gaze_estimators.{i}``), so a released
``.pth.tar`` loads with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from rot_mvgaze_tpu_torch.models.blocks import Mlp
from rot_mvgaze_tpu_torch.models.norm import IntensityBatchNorm
from rot_mvgaze_tpu_torch.models.resnet import BACKBONES
from rot_mvgaze_tpu_torch.ops import fusion
from rot_mvgaze_tpu_torch.parallel import spatial

NUM_FEAT_VEC = 512


class Feat3dLifter(nn.Module):
    """Lifts a backbone feature to a rotatable (3, num_feat_vec) matrix."""

    def __init__(self, in_features: int, num_feat_vec: int = NUM_FEAT_VEC) -> None:
        super().__init__()
        self.num_feat_vec = num_feat_vec
        self._lifter = Mlp(in_features, [num_feat_vec * 3, num_feat_vec * 3])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._lifter(x).reshape(-1, 3, self.num_feat_vec)


class ImageFeatFuser(nn.Module):
    """Two-layer MLP fusing a view's image feature with the other view's
    rotatable feature, rotated into this view by ``rot``.

    Layer 1 (rotate + concat + GEMM + bias + ReLU) is
    :class:`rot_mvgaze_tpu_torch.ops.fusion.RotateConcatMatmulRelu`: the
    hand-written CUDA kernel for a CUDA tensor, its plain PyTorch version for
    a CPU tensor, and a backward of plain products. Layer 2 is ``F.linear``.
    Autocast does not reach the custom op, so it casts at its own boundary,
    as the JAX package's ``_FusedFuserMlp`` does: activations and W1 to the
    compute dtype (autocast's, when autocast is on for the device, else the
    image feature's), b1 to float32; gradients reach float32 parameters
    through the casts. The output stays in the compute dtype (bf16 in bf16
    serving), as on the JAX package's plain path; the JAX Pallas path returns
    float32 there because its layer-2 bias is float32.

    With ``rot=None`` (the ``ignore_rotmat`` ablation and the V-view model,
    whose partners arrive rotated) the unrotated feature is concatenated and
    both layers run through ``F.linear``, as the JAX package computes that
    branch outside any Pallas kernel.
    """

    def __init__(self, img_feat_dim: int, num_feat_vec: int = NUM_FEAT_VEC) -> None:
        super().__init__()
        self.num_feat_vec = num_feat_vec
        in_channel = img_feat_dim + num_feat_vec * 3
        self._fuser = Mlp(in_channel, [in_channel, num_feat_vec * 3])

    def forward(
        self, img_feat: torch.Tensor, rot_feat: torch.Tensor, rot: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        if rot is None:
            flat = rot_feat.reshape(rot_feat.shape[0], -1)
            return self._fuser(torch.cat([img_feat, flat], dim=-1)).reshape(-1, 3, self.num_feat_vec)
        layer1 = self._fuser.blocks[0][0]
        layer2 = self._fuser.blocks[1][0]
        device = img_feat.device.type
        dtype = (
            torch.get_autocast_dtype(device)
            if torch.is_autocast_enabled(device) else img_feat.dtype
        )
        out = fusion.fused_image_feat_fuser(
            img_feat.to(dtype), rot_feat.to(dtype).contiguous(), rot.float().contiguous(),
            layer1.weight.to(dtype), layer1.bias.float(), layer2.weight, layer2.bias,
        )
        return out.reshape(-1, 3, self.num_feat_vec)


class ImageRotmatFeatFuser(nn.Module):
    """``encode_rotmat``: a 3-layer MLP over the image feature, the
    unrotated partner feature and the flattened relative rotation (cast to
    the image feature's dtype); in width D + 3K + 9."""

    def __init__(self, img_feat_dim: int, num_feat_vec: int = NUM_FEAT_VEC) -> None:
        super().__init__()
        self.num_feat_vec = num_feat_vec
        in_channel = img_feat_dim + num_feat_vec * 3 + 9
        self._fuser = Mlp(in_channel, [in_channel, in_channel, num_feat_vec * 3])

    def forward(self, img_feat: torch.Tensor, rot_feat: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
        n = img_feat.shape[0]
        in_feat = torch.cat(
            [img_feat, rot_feat.reshape(n, -1), rot.reshape(n, 9).to(img_feat.dtype)], dim=-1
        )
        return self._fuser(in_feat).reshape(-1, 3, self.num_feat_vec)


class RotFeatFuser(nn.Module):
    """``share_feature``: one :class:`IntensityBatchNorm` applied to
    ``feat_0`` and then to ``feat_1`` (in train mode the second call sees the
    first call's update), the two concatenated along the channel axis and
    flattened, then a 3-layer MLP of in width 6K."""

    def __init__(self, num_feat_vec: int = NUM_FEAT_VEC) -> None:
        super().__init__()
        self.num_feat_vec = num_feat_vec
        in_channel = num_feat_vec * 6
        self._batchnorm = IntensityBatchNorm(num_feat_vec)
        self._fuser = Mlp(in_channel, [in_channel, in_channel, num_feat_vec * 3])

    def forward(self, feat_0: torch.Tensor, feat_1: torch.Tensor) -> torch.Tensor:
        f0 = self._batchnorm(feat_0)
        f1 = self._batchnorm(feat_1)
        in_feat = torch.cat([f0, f1], dim=-1).reshape(feat_0.shape[0], -1)
        return self._fuser(in_feat).reshape(-1, 3, self.num_feat_vec)


def rotate(rot: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """(B,3,3) @ (B,3,K) in float32 (float64 for a float64 ``feat``) with
    autocast off, back in ``feat``'s dtype, as the JAX package's
    full-precision ``_rotate``."""
    acc = torch.promote_types(feat.dtype, torch.float32)
    with torch.autocast(feat.device.type, enabled=False):
        return (rot.to(acc) @ feat.to(acc)).to(feat.dtype)


class FeatRotationSymm(nn.Module):
    """Twin-backbone, iterative rotation-constrained cross-view fusion.
    ``backbone_depth`` is an int depth or a ``BACKBONES`` name.

    In train mode the backbone and the lifter run once per view, so that
    the BatchNorm statistics stay per view and each running statistic
    updates twice per step, as flax does when the module is called twice;
    with ``fuse_views`` both views run as one batch in train mode too, so
    the statistics merge across views and each running statistic updates
    once. In eval both views always run as one batch (BN then uses running
    statistics, so this changes nothing but the batch size).

    ``int8_backbone`` (False, True or "static") runs the backbone's convs
    on the int8 path in eval (``models/resnet.py::QuantConv2d``); the state
    dict is unchanged. ``bn_stat_subsample`` and ``remat`` are the
    backbone's (``models/resnet.py``); ``bn_stat_subsample > 1`` with
    ``fuse_views`` is refused, as in the JAX package: the prefix of the
    stacked [view 0; view 1] batch would be view 0's rows alone.

    ``share_weights`` reuses one fuser and one head across iterations,
    aliased as the reference does (``ModuleList([m] * n)``). The fuser
    kernel runs on the default path only; the ablations' fusers are plain
    ``F.linear`` MLPs, as in the JAX package. The combinations the JAX
    package refuses raise ``ValueError`` here too: ``ignore_rotmat`` with
    ``encode_rotmat``, and ``share_feature`` with ``encode_rotmat`` or
    ``share_weights``.
    """

    def __init__(
        self,
        backbone_depth: Any = 50,
        num_iter: int = 3,
        share_weights: bool = False,
        encode_rotmat: bool = False,
        share_feature: bool = False,
        ignore_rotmat: bool = False,
        num_feat_vec: int = NUM_FEAT_VEC,
        fuse_views: bool = False,
        int8_backbone: Any = False,
        bn_stat_subsample: int = 1,
        remat: bool = False,
    ) -> None:
        super().__init__()
        if fuse_views and bn_stat_subsample > 1:
            raise ValueError(
                "fuse_views=True stacks the batch as [view0; view1], so bn_stat_subsample's "
                "contiguous-prefix slice would compute BN statistics from view-0 rows ONLY "
                "(systematic, not the documented i.i.d. subsample). Use one or the other."
            )
        if ignore_rotmat and encode_rotmat:
            raise ValueError("ignore_rotmat cannot be combined with encode_rotmat")
        if share_feature and (encode_rotmat or share_weights):
            raise ValueError(
                "share_feature cannot be combined with encode_rotmat or share_weights (these "
                "combinations crash in the reference model and have no trained counterpart)"
            )
        self.backbone_depth = backbone_depth
        self.num_iter = num_iter
        self.share_weights = share_weights
        self.encode_rotmat = encode_rotmat
        self.share_feature = share_feature
        self.ignore_rotmat = ignore_rotmat
        self.num_feat_vec = num_feat_vec
        self.fuse_views = fuse_views
        self.int8_backbone = int8_backbone
        self.bn_stat_subsample = bn_stat_subsample
        self.remat = remat
        backbone = BACKBONES[backbone_depth](int8=int8_backbone, bn_stat_subsample=bn_stat_subsample,
                                             remat=remat)
        fc_dim = backbone.feature_dim
        self._feat_extractor = nn.Sequential(backbone)
        self._lifter = Feat3dLifter(fc_dim, num_feat_vec)

        def make_fuser() -> nn.Module:
            if share_feature:
                return RotFeatFuser(num_feat_vec)
            if encode_rotmat:
                return ImageRotmatFeatFuser(fc_dim, num_feat_vec)
            return ImageFeatFuser(fc_dim, num_feat_vec)

        def make_head() -> nn.Module:
            return Mlp(num_feat_vec * 6 if share_feature else fc_dim + num_feat_vec * 3, [512, 2])

        if share_weights:
            self._img_fusers = nn.ModuleList([make_fuser()] * num_iter)
            self._gaze_estimators = nn.ModuleList([make_head()] * num_iter)
        else:
            self._img_fusers = nn.ModuleList(make_fuser() for _ in range(num_iter))
            self._gaze_estimators = nn.ModuleList(
                make_head() for _ in range(num_iter)
            )

    @property
    def spatial_unshard(self) -> Optional[int]:
        """The backbone's spatial floor (``parallel.with_spatial_floor``):
        with it set, ``img_0`` and ``img_1`` may arrive as height strips
        (``parallel.spatial.Sharded``), and every backbone call runs on
        them."""
        return self._feat_extractor[0].spatial_unshard

    @spatial_unshard.setter
    def spatial_unshard(self, value: Optional[int]) -> None:
        self._feat_extractor[0].spatial_unshard = value

    def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
        img_0, img_1 = data["img_0"], data["img_1"]
        rot_0 = data["rot_0"].float()
        rot_1 = data["rot_1"].float()
        # the 3x3 composes stay float32 under autocast, as JAX keeps them at
        # HIGHEST precision
        with torch.autocast(rot_0.device.type, enabled=False):
            rot_10 = rot_0 @ rot_1.transpose(-1, -2)
            rot_01 = rot_1 @ rot_0.transpose(-1, -2)

        n = img_0.shape[0]
        if self.training and not self.fuse_views:
            img_feat_0 = self._feat_extractor(img_0)
            img_feat_1 = self._feat_extractor(img_1)
            rot_feat_0 = self._lifter(img_feat_0)
            rot_feat_1 = self._lifter(img_feat_1)
        else:
            both = self._feat_extractor(spatial.cat_batch([img_0, img_1]))
            lifted = self._lifter(both)
            img_feat_0, img_feat_1 = both[:n], both[n:]
            rot_feat_0, rot_feat_1 = lifted[:n], lifted[n:]
        if self.share_feature:
            # the fusers and heads read the initial rotatable features
            img_feat_0, img_feat_1 = rot_feat_0, rot_feat_1

        pred: Dict[str, Any] = {
            "num_iter": self.num_iter,
            "img_feat_0": img_feat_0,
            "img_feat_1": img_feat_1,
            "initial_rot_feat_0": rot_feat_0,
            "initial_rot_feat_1": rot_feat_1,
        }
        for i in range(self.num_iter):
            fuser = self._img_fusers[i]
            head = self._gaze_estimators[i]
            feat_0_prev = rot_feat_0
            if self.share_feature:
                # ignore_rotmat composes: the unrotated partners
                if self.ignore_rotmat:
                    partner_1, partner_0 = rot_feat_1, feat_0_prev
                else:
                    partner_1, partner_0 = rotate(rot_10, rot_feat_1), rotate(rot_01, feat_0_prev)
                rot_feat_0 = fuser(img_feat_0, partner_1)
                rot_feat_1 = fuser(img_feat_1, partner_0)
                # [f_init, f'] along the channel axis, then flattened
                head_in_0 = torch.cat([img_feat_0, rot_feat_0], -1).reshape(n, -1)
                head_in_1 = torch.cat([img_feat_1, rot_feat_1], -1).reshape(n, -1)
            else:
                # ignore_rotmat: no rotation; encode_rotmat: the raw rotation
                # concatenated; else rotated into this view by the fuser
                r_10, r_01 = (None, None) if self.ignore_rotmat else (rot_10, rot_01)
                rot_feat_0 = fuser(img_feat_0, rot_feat_1, r_10)
                rot_feat_1 = fuser(img_feat_1, feat_0_prev, r_01)
                head_in_0 = torch.cat([img_feat_0, rot_feat_0.reshape(n, -1)], -1)
                head_in_1 = torch.cat([img_feat_1, rot_feat_1.reshape(n, -1)], -1)
            pred[f"iter_{i}"] = {
                "feat_0": rot_feat_0,
                "feat_1": rot_feat_1,
                "pred_gaze_0": head(head_in_0),
                "pred_gaze_1": head(head_in_1),
            }
        pred["pred_gaze"] = pred[f"iter_{self.num_iter - 1}"]["pred_gaze_0"]
        out = dict(data)
        out.update(pred)
        return out
