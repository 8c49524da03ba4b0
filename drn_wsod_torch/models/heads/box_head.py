"""DiscriminativeAdaptionNeck (DAN) box head (counterpart of
``drn_wsod_tpu/models/heads/box_head.py``).

``NUM_FC`` fully-connected layers, each followed by ReLU and dropout, over
(N, 7*7*C) pooled features. The input is flattened in (7, 7, C) order, as
in the JAX package; a Detectron2 checkpoint's fc1 is (C, 7, 7)-ordered and
needs its input axis permuted when it is loaded. The weights stay float32
and the products run in the model's dtype (:class:`..layers.Dense`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Dense


def fast_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout with the masks drawn from ``generator`` (counterpart of
    ``FastDropout``): the identity when ``generator`` is None (eval) or the
    rate is 0; ``where(keep, x + x, 0)`` at rate 0.5, the DAN's rate;
    ``where(keep, x / (1 - rate), 0)`` otherwise. The masks differ from
    JAX's by construction (another generator)."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(
        1.0 - rate, generator=generator)
    if rate == 0.5:
        return torch.where(keep, x + x, 0.0)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class DiscriminativeAdaptionNeck(nn.Module):
    def __init__(self, in_features: int, dan_dims: Sequence[int],
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_features, *dan_dims]
        self.num_fc = len(dan_dims)
        self.dropout = dropout
        for i in range(self.num_fc):
            self.add_module(f"fc{i + 1}", Dense(dims[i], dims[i + 1], dtype))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dropout runs where a ``generator`` is given (training)."""
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
            x = fast_dropout(x, self.dropout, generator)
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """fc weights N(0, 0.005), bias 0.1 (reference DAN init)."""
        for i in range(self.num_fc):
            fc = getattr(self, f"fc{i + 1}")
            fc.weight.normal_(0.0, 0.005, generator=generator)
            fc.bias.fill_(0.1)
