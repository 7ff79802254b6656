"""V-view rotation-constrained fusion (port of
``rot_mvgaze_tpu/models/multiview.py``).

Each view's rotatable feature is fused with the mean of every other view's
feature rotated into its frame::

    partner_v = mean_{w != v}  (R_v R_w^T) @ f_w          (pre-update f_w)
    f_v'      = fuser_i(img_feat_v, partner_v)
    g_v       = head_i([img_feat_v, f_v'])

At V=2 the mean over one partner is that partner, so this is the stereo
model's update. Every submodule keeps the stereo model's name and shape
(``_feat_extractor.0``, ``_lifter._lifter``, ``_img_fusers.{i}._fuser``,
``_gaze_estimators.{i}``; the mean keeps the fuser's in width independent
of V), so a stereo state dict loads strictly at any V.

All B·V images go through the backbone and the lifter as one batch, so
train-mode BatchNorm statistics merge across views (the V-view counterpart
of ``fuse_views``). The fusers are called with ``rot=None`` (the partners
arrive rotated), as in the JAX package, so they are ``F.linear`` MLPs.

Input  : ``{"imgs": (B,V,H,W,C), "rots": (B,V,3,3), ...}``; on a data mesh
``imgs`` are the B·V views flattened b-major as ``parallel.spatial.Sharded``
blocks over the replicas (``parallel.shard_batch``), B and V read from
``rots``: the backbone runs on the blocks, its pooled (B·V, D) features
meet the rest on the first device in global order, and the train-mode
BatchNorm statistics are the whole batch's. In place of ``imgs``, the
pooled backbone features ``BACKBONE_FEATURES`` (B·V, D), taken elsewhere
(``FeatRotationSymm``'s docstring).
Output : input ∪ ``{num_iter, num_views, img_feats (B,V,D),
          initial_rot_feats (B,V,3,K),
          iter_{i}: {feats (B,V,3,K), pred_gazes (B,V,2)},
          pred_gaze (B,2) = last iteration, view 0}``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from rot_mvgaze_tpu_torch.models.blocks import Mlp
from rot_mvgaze_tpu_torch.models.resnet import BACKBONES
from rot_mvgaze_tpu_torch.models.rot_mv import BACKBONE_FEATURES, NUM_FEAT_VEC, Feat3dLifter, ImageFeatFuser
from rot_mvgaze_tpu_torch.parallel.spatial import Sharded


class FeatRotationMultiView(nn.Module):
    """V-view fusion with the default fuser and the ``share_weights`` and
    ``ignore_rotmat`` (unrotated partners) ablations. ``encode_rotmat`` and
    ``share_feature`` have no V-view counterpart, as in the JAX package. V
    is the input's, at least 2. ``int8_backbone`` and ``remat`` as in
    ``FeatRotationSymm``."""

    def __init__(
        self,
        backbone_depth: Any = 50,
        num_iter: int = 3,
        share_weights: bool = False,
        ignore_rotmat: bool = False,
        num_feat_vec: int = NUM_FEAT_VEC,
        int8_backbone: Any = False,
        remat: bool = False,
    ) -> None:
        super().__init__()
        self.backbone_depth = backbone_depth
        self.num_iter = num_iter
        self.share_weights = share_weights
        self.ignore_rotmat = ignore_rotmat
        self.num_feat_vec = num_feat_vec
        self.int8_backbone = int8_backbone
        self.remat = remat
        backbone = BACKBONES[backbone_depth](int8=int8_backbone, remat=remat)
        fc_dim = backbone.feature_dim
        self._feat_extractor = nn.Sequential(backbone)
        self._lifter = Feat3dLifter(fc_dim, num_feat_vec)

        def make_head() -> nn.Module:
            return Mlp(fc_dim + num_feat_vec * 3, [512, 2])

        if share_weights:
            self._img_fusers = nn.ModuleList([ImageFeatFuser(fc_dim, num_feat_vec)] * num_iter)
            self._gaze_estimators = nn.ModuleList([make_head()] * num_iter)
        else:
            self._img_fusers = nn.ModuleList(ImageFeatFuser(fc_dim, num_feat_vec) for _ in range(num_iter))
            self._gaze_estimators = nn.ModuleList(make_head() for _ in range(num_iter))

    def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
        rots = data["rots"].float()
        b, v = rots.shape[0], rots.shape[1]
        if v < 2:
            raise ValueError(f"need at least 2 views, got V={v}")
        k = self.num_feat_vec
        img_feats_flat = data.get(BACKBONE_FEATURES)
        if img_feats_flat is None:
            imgs = data["imgs"]
            if isinstance(imgs, Sharded):
                if imgs.shape[0] != b * v:
                    raise ValueError(f"imgs on a mesh hold {imgs.shape[0]} views, rots {b} x {v}")
            else:
                imgs = imgs.reshape((b * v,) + tuple(imgs.shape[2:]))
            img_feats_flat = self._feat_extractor(imgs)
        rot_feats_flat = self._lifter(img_feats_flat)  # (B*V, 3, K)

        with torch.autocast(rots.device.type, enabled=False):
            # rel[b, v, w] = R_v R_w^T takes view w's feature into view v's frame
            rel = torch.einsum("bvij,bwkj->bvwik", rots, rots)
            not_self = (1.0 - torch.eye(v, device=rots.device)).reshape(1, v, v, 1, 1)

        pred: Dict[str, Any] = {
            "num_iter": self.num_iter,
            "num_views": v,
            "img_feats": img_feats_flat.reshape(b, v, -1),
            "initial_rot_feats": rot_feats_flat.reshape(b, v, 3, k),
        }
        feats = rot_feats_flat.reshape(b, v, 3, k)
        # the partners in float32 (float64 for a float64 model), as the fuser's rotation
        acc = torch.promote_types(feats.dtype, torch.float32)
        for i in range(self.num_iter):
            with torch.autocast(rots.device.type, enabled=False):
                if self.ignore_rotmat:
                    rotated = feats.to(acc)[:, None].expand(b, v, v, 3, k)
                else:
                    rotated = torch.einsum("bvwik,bwkn->bvwin", rel.to(acc), feats.to(acc))
                partners = ((rotated * not_self).sum(dim=2) / (v - 1)).to(feats.dtype)
            new_flat = self._img_fusers[i](img_feats_flat, partners.reshape(b * v, 3, k))
            feats = new_flat.reshape(b, v, 3, k)
            head_in = torch.cat([img_feats_flat, new_flat.reshape(b * v, -1)], dim=-1)
            gazes = self._gaze_estimators[i](head_in).reshape(b, v, 2)
            pred[f"iter_{i}"] = {"feats": feats, "pred_gazes": gazes}
        pred["pred_gaze"] = pred[f"iter_{self.num_iter - 1}"]["pred_gazes"][:, 0]
        out = dict(data)
        out.update(pred)
        return out
