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
    """Conv with bias (unless ``bias`` is False) and symmetric padding
    ``dilation * (k // 2)``, computed as flax's ``nn.Conv(dtype=...)``
    computes it: input, weight and bias cast to ``dtype`` (the input's own
    where None) at each use, so parameters stay float32 masters; the
    product is rounded, then the bias added and rounded again (a bias fused
    into the product would round once)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 dilation: int = 1, dtype: torch.dtype = None,
                 bias: bool = True):
        super().__init__(in_channels, out_channels, kernel,
                         padding=dilation * (kernel // 2), dilation=dilation,
                         bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is None:
            return y
        return y + self.bias.to(dt)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """Flax's ``nn.ConvTranspose(features, (k, k), strides=(s, s),
    padding="SAME", dtype=...)`` (``transpose_kernel`` False) as a torch
    transposed conv: padding ``(k - s) // 2`` and the flax kernel flipped
    in both spatial axes, stored in torch's (in, out, k, k) layout
    (``checkpoint/from_jax.py`` flips it on the way in). Computed as
    flax computes it: input, weight and bias cast to ``dtype`` (the
    input's own where None) at each use, the product rounded before the
    bias is added."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int, dtype: torch.dtype = None):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=(kernel - stride) // 2)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None,
                               self.stride, self.padding)
        return y + self.bias.to(dt)[:, None, None]


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """Flax's default kernel init (``lecun_normal``): a normal of variance
    1 / fan_in truncated at two standard deviations, its std corrected for
    the truncation."""
    std = fan_in ** -0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
