"""VGG-16 backbone (counterpart of ``drn_wsod_tpu/models/backbones/vgg.py``).

Five "plain" stages of 3x3 convs with biases and ReLU, no norm:
(64, 2) (128, 2) (256, 3) (512, 3) (512, 3) as (channels, convs). Stages 1-3
end in a 2x2 VALID max-pool of stride 2; ``plain4``'s pool has stride 1
under ``CONV5_DILATION 2`` (each side shrinks by one cell), else 2;
``plain5`` is dilated and has no pool. Its output, at stride 8 with 512
channels under dilation 2, is the feature the WSOD heads pool.

Modules follow Detectron2's names (``plain1.0.conv1.weight`` and
``.bias``), so ``vgg16_d2.pkl`` loads by name. The tower takes NCHW
tensors in ``channels_last`` memory, as ``resnet_ws.py``'s does.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d

# (out_channels, num_conv) per stage of VGG-16
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class PlainBlock(nn.Module):
    """``num_conv`` 3x3 convs with biases (``layers.Conv2d``: computed in
    the input's dtype, the bias rounded in after the product, as flax
    does), each followed by ReLU, then an optional 2x2 VALID max-pool."""

    def __init__(self, in_channels: int, out_channels: int, num_conv: int,
                 dilation: int = 1, has_pool: bool = False,
                 pool_stride: int = 2):
        super().__init__()
        self.num_conv = num_conv
        for i in range(1, num_conv + 1):
            self.add_module(f"conv{i}", Conv2d(
                in_channels if i == 1 else out_channels, out_channels, 3,
                dilation))
        self.has_pool, self.pool_stride = has_pool, pool_stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.num_conv + 1):
            x = F.relu(getattr(self, f"conv{i}")(x))
        if self.has_pool:
            x = F.max_pool2d(x, kernel_size=2, stride=self.pool_stride)
        return x


class VGG16(nn.Module):
    """The VGG-16 tower; returns {stage: NCHW map} for ``out_features``.
    Each stage is a one-block ``nn.Sequential`` (Detectron2's
    ``plainN.0.`` names)."""

    def __init__(self, conv5_dilation: int = 2, out_features=("plain5",)):
        super().__init__()
        self.conv5_dilation = conv5_dilation
        self.out_features = tuple(out_features)
        in_ch = 3
        for i, (channels, num_conv) in enumerate(VGG16_STAGES, start=1):
            if i <= 3:
                block = PlainBlock(in_ch, channels, num_conv, has_pool=True,
                                   pool_stride=2)
            elif i == 4:
                block = PlainBlock(in_ch, channels, num_conv, has_pool=True,
                                   pool_stride=1 if conv5_dilation == 2
                                   else 2)
            else:
                block = PlainBlock(in_ch, channels, num_conv,
                                   dilation=conv5_dilation)
            self.add_module(f"plain{i}", nn.Sequential(block))
            in_ch = channels

    @property
    def feature_strides(self) -> Dict[str, int]:
        s4 = 8 if self.conv5_dilation == 2 else 16
        return {"plain1": 2, "plain2": 4, "plain3": 8, "plain4": s4,
                "plain5": s4}

    @property
    def feature_channels(self) -> Dict[str, int]:
        return {f"plain{i + 1}": c for i, (c, _) in enumerate(VGG16_STAGES)}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        for i in range(1, len(VGG16_STAGES) + 1):
            name = f"plain{i}"
            x = getattr(self, name)(x)
            if name in self.out_features:
                outputs[name] = x
        return outputs


def build_vgg_backbone(cfg) -> VGG16:
    """Config-driven builder (``vgg.py:build_vgg_backbone``)."""
    if cfg.MODEL.VGG.DEPTH != 16:
        raise ValueError("only VGG-16 is defined (as in the reference)")
    return VGG16(conv5_dilation=cfg.MODEL.VGG.CONV5_DILATION,
                 out_features=tuple(cfg.MODEL.VGG.OUT_FEATURES))
