"""Layers shared by the heads and the VGG backbone."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` whose parameters stay in their own dtype (float32
    masters) while the product runs in ``dtype``: input, weight and bias are
    cast at each use. This is flax's ``nn.Dense(dtype=..., param_dtype=
    float32)``, which the JAX package's heads use, so SGD updates land on
    float32 values and are not rounded away in bfloat16."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """Conv with bias and symmetric padding ``dilation * (k // 2)``,
    computed as flax's ``nn.Conv(dtype=...)`` computes it: input, weight
    and bias cast to ``dtype`` (the input's own where None) at each use,
    so parameters stay float32 masters; the product is rounded, then the
    bias added and rounded again (a bias fused into the product would round
    once)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 dilation: int = 1, dtype: torch.dtype = None):
        super().__init__(in_channels, out_channels, kernel,
                         padding=dilation * (kernel // 2), dilation=dilation)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y + self.bias.to(dt)[:, None, None]
