"""WSDDN two-stream MIL head (counterpart of
``drn_wsod_tpu/models/heads/wsddn.py``).

  scores = softmax(cls(x), over classes) * softmax(det(x), over proposals)

The detection-stream softmax runs per image over the valid proposals only:
padded slots are masked to -inf before it and zeroed after it (an image with
no valid slot gives all zeros).
"""

from __future__ import annotations

import math

import torch
from torch import nn

CLAMP_LO = 1e-6
CLAMP_HI = 1.0 - 1e-6


class WSDDNOutputLayers(nn.Module):
    """The two linear streams; returns per-proposal MIL scores."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.cls = nn.Linear(in_features, num_classes)
        self.det = nn.Linear(in_features, num_classes)

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


def append_background(scores: torch.Tensor) -> torch.Tensor:
    """Add the zero background column used at inference.
    (B, P, C) -> (B, P, C+1)."""
    return torch.cat([scores, scores.new_zeros(scores.shape[:-1] + (1,))],
                     dim=-1)
