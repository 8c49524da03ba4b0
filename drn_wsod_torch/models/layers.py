"""Layers shared by the heads."""

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
