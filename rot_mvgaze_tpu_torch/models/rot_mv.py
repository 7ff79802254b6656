"""Rotation-constrained cross-view gaze fusion model: port of the default
path of ``rot_mvgaze_tpu/models/rot_mv.py``, in train and eval mode.

input  : {img_0, img_1 (N,H,W,3) float, rot_0, rot_1 (N,3,3)}
output : input ∪ {num_iter, img_feat_{0,1}, initial_rot_feat_{0,1},
                  iter_{i}: {feat_0, feat_1, pred_gaze_0, pred_gaze_1},
                  pred_gaze}

Per iteration i::

    rot_10 = R0 @ R1^T ;  rot_01 = R1 @ R0^T          (float32)
    f0' = fuser_i(img_feat_0, rot_10 @ f1)
    f1' = fuser_i(img_feat_1, rot_01 @ f0)            # uses PRE-update f0
    g0  = head_i([img_feat_0, f0'])
    g1  = head_i([img_feat_1, f1'])

The module tree carries the reference checkpoints' names
(``_feat_extractor.0``, ``_lifter._lifter``, ``_img_fusers.{i}._fuser``,
``_gaze_estimators.{i}``), so a released ``.pth.tar`` loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from rot_mvgaze_tpu_torch.models.blocks import Mlp
from rot_mvgaze_tpu_torch.models.resnet import BACKBONES
from rot_mvgaze_tpu_torch.ops import fusion

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
    """

    def __init__(self, img_feat_dim: int, num_feat_vec: int = NUM_FEAT_VEC) -> None:
        super().__init__()
        self.num_feat_vec = num_feat_vec
        in_channel = img_feat_dim + num_feat_vec * 3
        self._fuser = Mlp(in_channel, [in_channel, num_feat_vec * 3])

    def forward(
        self, img_feat: torch.Tensor, rot_feat: torch.Tensor, rot: torch.Tensor
    ) -> torch.Tensor:
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


class FeatRotationSymm(nn.Module):
    """Twin-backbone, iterative rotation-constrained cross-view fusion.
    ``backbone_depth`` is an int depth or a ``BACKBONES`` name.

    In train mode the backbone and the lifter run once per view, so that
    the BatchNorm statistics stay per view and each running statistic
    updates twice per step, as flax does when the module is called twice. In
    eval both views run as one batch (BN then uses running statistics, so
    this changes nothing but the batch size).

    ``share_weights`` reuses one fuser and one head across iterations,
    aliased as the reference does (``ModuleList([m] * n)``). The other
    ablations are not ported yet.
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
    ) -> None:
        super().__init__()
        for flag, name in (
            (encode_rotmat, "encode_rotmat"),
            (share_feature, "share_feature"),
            (ignore_rotmat, "ignore_rotmat"),
        ):
            if flag:
                raise NotImplementedError(
                    f"{name} is not ported yet (ROADMAP A5)"
                )
        self.backbone_depth = backbone_depth
        self.num_iter = num_iter
        self.share_weights = share_weights
        self.num_feat_vec = num_feat_vec
        backbone = BACKBONES[backbone_depth]()
        fc_dim = backbone.feature_dim
        self._feat_extractor = nn.Sequential(backbone)
        self._lifter = Feat3dLifter(fc_dim, num_feat_vec)

        def make_fuser() -> nn.Module:
            return ImageFeatFuser(fc_dim, num_feat_vec)

        def make_head() -> nn.Module:
            return Mlp(fc_dim + num_feat_vec * 3, [512, 2])

        if share_weights:
            self._img_fusers = nn.ModuleList([make_fuser()] * num_iter)
            self._gaze_estimators = nn.ModuleList([make_head()] * num_iter)
        else:
            self._img_fusers = nn.ModuleList(make_fuser() for _ in range(num_iter))
            self._gaze_estimators = nn.ModuleList(
                make_head() for _ in range(num_iter)
            )

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
        if self.training:
            img_feat_0 = self._feat_extractor(img_0)
            img_feat_1 = self._feat_extractor(img_1)
            rot_feat_0 = self._lifter(img_feat_0)
            rot_feat_1 = self._lifter(img_feat_1)
        else:
            both = self._feat_extractor(torch.cat([img_0, img_1], dim=0))
            lifted = self._lifter(both)
            img_feat_0, img_feat_1 = both[:n], both[n:]
            rot_feat_0, rot_feat_1 = lifted[:n], lifted[n:]

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
            rot_feat_0 = fuser(img_feat_0, rot_feat_1, rot_10)
            rot_feat_1 = fuser(img_feat_1, feat_0_prev, rot_01)
            pred[f"iter_{i}"] = {
                "feat_0": rot_feat_0,
                "feat_1": rot_feat_1,
                "pred_gaze_0": head(torch.cat([img_feat_0, rot_feat_0.reshape(n, -1)], -1)),
                "pred_gaze_1": head(torch.cat([img_feat_1, rot_feat_1.reshape(n, -1)], -1)),
            }
        pred["pred_gaze"] = pred[f"iter_{self.num_iter - 1}"]["pred_gaze_0"]
        out = dict(data)
        out.update(pred)
        return out
