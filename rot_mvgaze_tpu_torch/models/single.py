"""Single-view gaze regression baseline (port of
``rot_mvgaze_tpu/models/single.py``): ResNet backbone -> MLP -> (pitch, yaw).

The module tree is ``_feat_extractor.0`` (the backbone, named as in the
stereo model) and ``_gaze_estimator.blocks.{j}.0``; the reference has no
such model, so there are no released checkpoints to match.
"""

from __future__ import annotations

from typing import Any, Dict, Union

import torch
from torch import nn

from rot_mvgaze_tpu_torch.models.blocks import Mlp
from rot_mvgaze_tpu_torch.models.resnet import BACKBONES


class SingleViewGazeNet(nn.Module):
    """ResNet backbone -> MLP ``[head_hidden, 2]`` -> (pitch, yaw).

    ``forward`` takes a raw NHWC image batch (returns pitchyaw) or the dict
    contract (reads ``img_0``, adds ``img_feat_0`` and ``pred_gaze``).
    ``remat`` recomputes the backbone's blocks in the backward."""

    def __init__(self, backbone_depth: Any = 18, head_hidden: int = 512, remat: bool = False) -> None:
        super().__init__()
        self.backbone_depth = backbone_depth
        self.remat = remat
        backbone = BACKBONES[backbone_depth](remat=remat)
        self._feat_extractor = nn.Sequential(backbone)
        self._gaze_estimator = Mlp(backbone.feature_dim, [head_hidden, 2])

    def forward(
        self, data: Union[Dict[str, Any], torch.Tensor]
    ) -> Union[Dict[str, Any], torch.Tensor]:
        if isinstance(data, dict):
            feat = self._feat_extractor(data["img_0"])
            out = dict(data)
            out.update({"img_feat_0": feat, "pred_gaze": self._gaze_estimator(feat)})
            return out
        return self._gaze_estimator(self._feat_extractor(data))
