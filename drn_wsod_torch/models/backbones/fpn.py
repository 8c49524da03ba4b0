"""Feature Pyramid Network over the WS-ResNet (counterpart of
``drn_wsod_tpu/models/backbones/fpn.py``).

Lateral 1x1 convs, a top-down path adding each coarser sum, upsampled by
nearest neighbour to the lateral's size, and 3x3 output convs per level;
p6 is p5 subsampled with stride 2. Both convs carry a bias and compute in
the model's dtype from float32 masters (flax's ``nn.Conv(dtype=...)``).
The bottom-up tower is the WS-ResNet's pyramid variant (strides 4/8/16/32),
built as the JAX package builds it: ``RES5_DILATION``, ``NORM`` and the
deformable settings are not read. Names follow Detectron2's
(``backbone.bottom_up.res2.0.conv1``, ``backbone.fpn_lateral2``,
``backbone.fpn_output2``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..layers import Conv2d
from .resnet_ws import ResNetWS, model_dtype


def upsample_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, h, w) by ``jax.image.resize(..., "nearest")``'s
    index rule, ``floor((i + 0.5) * in / out)`` in float32 (on odd sizes
    it differs from ``F.interpolate(mode="nearest")``'s ``floor(i * in /
    out)``)."""
    for dim, n in ((2, h), (3, w)):
        m = x.shape[dim]
        if m != n:
            idx = torch.floor((torch.arange(n, dtype=torch.float32,
                                            device=x.device) + 0.5) * m / n)
            x = x.index_select(dim, idx.long())
    return x


class FPN(nn.Module):
    """The pyramid over ``bottom_up``'s ``in_features``; returns {"p2": ...,
    "p6": ...} NCHW maps of ``out_channels``."""

    def __init__(self, bottom_up: ResNetWS, in_features: Sequence[str],
                 out_channels: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bottom_up = bottom_up
        self.in_features = tuple(in_features)
        chans = bottom_up.feature_channels
        for f in self.in_features:
            n = f[-1]
            self.add_module(f"fpn_lateral{n}",
                            Conv2d(chans[f], out_channels, 1, dtype=dtype))
            self.add_module(f"fpn_output{n}",
                            Conv2d(out_channels, out_channels, 3, dtype=dtype))
        bu = bottom_up.feature_strides
        self.feature_strides = {f.replace("res", "p"): bu[f]
                                for f in self.in_features}
        self.feature_strides["p6"] = bu[self.in_features[-1]] * 2
        self.feature_channels = {k: out_channels for k in self.feature_strides}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        bottom = self.bottom_up(x)
        laterals = [getattr(self, f"fpn_lateral{f[-1]}")(bottom[f])
                    for f in self.in_features]
        outputs = [None] * len(laterals)
        prev = outputs[-1] = laterals[-1]
        for i in range(len(laterals) - 2, -1, -1):
            h, w = laterals[i].shape[2:]
            prev = outputs[i] = laterals[i] + upsample_nearest(prev, h, w)
        result = {f.replace("res", "p"):
                  getattr(self, f"fpn_output{f[-1]}")(out)
                  for f, out in zip(self.in_features, outputs)}
        result["p6"] = result[self.in_features[-1].replace("res", "p")][
            :, :, ::2, ::2]
        return result


def build_resnet_fpn_backbone(cfg) -> FPN:
    """``fpn.py:build_resnet_fpn_backbone``: the FPN over a WS-ResNet with
    ``pyramid=True`` (res2-res5, FrozenBN, no dilation)."""
    r = cfg.MODEL.RESNETS
    dtype = model_dtype(cfg)
    bottom_up = ResNetWS(
        depth=r.DEPTH, num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS, res5_dilation=1,
        out_features=("res2", "res3", "res4", "res5"), pyramid=True,
        dtype=dtype)
    return FPN(bottom_up, cfg.MODEL.FPN.IN_FEATURES,
               cfg.MODEL.FPN.OUT_CHANNELS, dtype=dtype)
