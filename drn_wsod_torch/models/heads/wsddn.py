"""WSDDN two-stream MIL head (counterpart of
``drn_wsod_tpu/models/heads/wsddn.py``).

  scores = softmax(cls(x), over classes) * softmax(det(x), over proposals)

The detection-stream softmax runs per image over the valid proposals only:
padded slots are masked to -inf before it and zeroed after it (an image with
no valid slot gives all zeros). Image evidence is the clamped per-class
sum of the scores; the loss is the binary cross-entropy against the
multi-hot image labels.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...parallel import context
from ..layers import Dense

CLAMP_LO = 1e-6
CLAMP_HI = 1.0 - 1e-6


class WSDDNOutputLayers(nn.Module):
    """The two linear streams; returns per-proposal MIL scores."""

    def __init__(self, in_features: int, num_classes: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls = Dense(in_features, num_classes, dtype)
        self.det = Dense(in_features, num_classes, dtype)

    def forward(self, feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """feats: (B, P, D); mask: (B, P) bool. Returns (B, P, C) float32
        scores, padded rows exactly zero."""
        cls_sm = torch.softmax(self.cls(feats).float(), dim=-1)
        m = mask[..., None]
        det = torch.where(m, self.det(feats).float(), -math.inf)
        det_sm = torch.softmax(det, dim=-2)
        return cls_sm * torch.where(m, det_sm, 0.0)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Xavier-uniform weights, zero bias."""
        for fc in (self.cls, self.det):
            bound = math.sqrt(6.0 / (fc.in_features + fc.out_features))
            fc.weight.uniform_(-bound, bound, generator=generator)
            fc.bias.zero_()


def image_probs(scores: torch.Tensor) -> torch.Tensor:
    """Per-image class evidence: clamped sum of proposal scores.
    (B, P, C) -> (B, C)."""
    return scores.sum(dim=-2).clamp(CLAMP_LO, CLAMP_HI)


def wsddn_loss(scores: torch.Tensor, labels: torch.Tensor,
               mean_loss: bool = True) -> torch.Tensor:
    """Binary cross-entropy between image probs and multi-hot labels,
    reduced by mean (or sum) and divided by the batch size, both over the
    global batch under a mesh shard (``parallel/context.py``).
    scores: (B, P, C); labels: (B, C) in {0, 1}."""
    p = image_probs(scores)
    bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    red = context.mean(bce) if mean_loss else bce.sum()
    return red / context.batch_size(scores.shape[0])


def append_background(scores: torch.Tensor) -> torch.Tensor:
    """Add the zero background column used at inference.
    (B, P, C) -> (B, P, C+1)."""
    return torch.cat([scores, scores.new_zeros(scores.shape[:-1] + (1,))],
                     dim=-1)
