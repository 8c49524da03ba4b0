"""DiscriminativeAdaptionNeck (DAN) box head, eval form (counterpart of
``drn_wsod_tpu/models/heads/box_head.py``).

``NUM_FC`` fully-connected layers with ReLU over (N, 7*7*C) pooled
features. The input is flattened in (7, 7, C) order, as in the JAX package;
a Detectron2 checkpoint's fc1 is (C, 7, 7)-ordered and needs its input axis
permuted when it is loaded. Dropout is the identity at eval; the training
dropout comes with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class DiscriminativeAdaptionNeck(nn.Module):
    def __init__(self, in_features: int, dan_dims: Sequence[int]):
        super().__init__()
        dims = [in_features, *dan_dims]
        self.num_fc = len(dan_dims)
        for i in range(self.num_fc):
            self.add_module(f"fc{i + 1}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """fc weights N(0, 0.005), bias 0.1 (reference DAN init)."""
        for i in range(self.num_fc):
            fc = getattr(self, f"fc{i + 1}")
            fc.weight.normal_(0.0, 0.005, generator=generator)
            fc.bias.fill_(0.1)
