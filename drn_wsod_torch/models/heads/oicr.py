"""OICR refinement branches, inference part (counterpart of
``drn_wsod_tpu/models/heads/oicr.py``). Pseudo-label mining and the branch
losses come with the training slice."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


class RefinementOutputLayers(nn.Module):
    """Linear cls (C+1) + linear box deltas of one refinement branch."""

    def __init__(self, in_features: int, num_classes: int,
                 cls_agnostic_bbox_reg: bool = False):
        super().__init__()
        num_reg = 1 if cls_agnostic_bbox_reg else num_classes
        self.cls_score = nn.Linear(in_features, num_classes + 1)
        self.bbox_pred = nn.Linear(in_features, num_reg * 4)

    def forward(self, feats: torch.Tensor):
        """feats: (B, P, D) -> (cls_logits (B, P, C+1), deltas (B, P, R*4)),
        both float32."""
        return self.cls_score(feats).float(), self.bbox_pred(feats).float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """cls N(0, 0.01), bbox N(0, 0.001), zero bias."""
        self.cls_score.weight.normal_(0.0, 0.01, generator=generator)
        self.bbox_pred.weight.normal_(0.0, 0.001, generator=generator)
        self.cls_score.bias.zero_()
        self.bbox_pred.bias.zero_()


def branch_probs(cls_logits: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities over K+1 classes; (B, P, C+1)."""
    return torch.softmax(cls_logits, dim=-1)


def average_branch_probs(cls_logits_list: Sequence[torch.Tensor]
                         ) -> torch.Tensor:
    """Inference-time mean of the branch softmaxes."""
    probs = [torch.softmax(lg, dim=-1) for lg in cls_logits_list]
    return sum(probs) / len(probs)
