"""OICR online instance refinement (counterpart of
``drn_wsod_tpu/models/heads/oicr.py``).

  * pseudo-GT mining: per present image class, the top-scoring valid
    proposal of the previous branch becomes a pseudo box, weighted by the
    WSDDN image evidence of that class;
  * proposal labelling: IoU-match every proposal against the pseudo boxes;
    >= 0.5 is foreground of the matched class, else background; every
    proposal inherits the weight of its best-matching pseudo box;
  * branch loss: weighted softmax cross-entropy over C+1 classes, divided by
    the number of proposals with weight > 1e-12;
  * optional per-branch box regression (L1 on the deltas).

A class-slot axis of size C replaces the variable-length present-class list:
absent classes drop out of matching through the ``valid`` mask. The JAX
functions are per image and vmapped; these take a leading batch axis.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ...ops.matcher import match
from ...parallel import context
from ...structures import boxes as box_ops
from ..layers import Dense


class RefinementOutputLayers(nn.Module):
    """Linear cls (C+1) + linear box deltas of one refinement branch."""

    def __init__(self, in_features: int, num_classes: int,
                 cls_agnostic_bbox_reg: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        num_reg = 1 if cls_agnostic_bbox_reg else num_classes
        self.cls_score = Dense(in_features, num_classes + 1, dtype)
        self.bbox_pred = Dense(in_features, num_reg * 4, dtype)

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


class PseudoTargets(NamedTuple):
    """Mined pseudo ground truth, one slot per class."""

    boxes: torch.Tensor    # (B, C, 4) seed box per class slot
    valid: torch.Tensor    # (B, C) bool, class present in the image labels
    weights: torch.Tensor  # (B, C) WSDDN image evidence per class
    scores: torch.Tensor   # (B, C) seed proposal score (statistics only)


def mine_pgt(prev_scores: torch.Tensor, prev_boxes: torch.Tensor,
             prop_mask: torch.Tensor, labels: torch.Tensor,
             img_evidence: torch.Tensor) -> PseudoTargets:
    """One pseudo box per present class.

    prev_scores: (B, P, C) previous-branch class scores; prev_boxes: (B, P, 4)
    class-agnostic or (B, P, C, 4) class-specific boxes; prop_mask: (B, P);
    labels: (B, C) multi-hot; img_evidence: (B, C) clamped WSDDN image
    probabilities. The seed is the first valid proposal of maximum score
    (padded slots are -inf)."""
    masked = torch.where(prop_mask[..., None], prev_scores, -torch.inf)
    seed_score, seed_idx = masked.max(dim=1)                       # (B, C)
    if prev_boxes.dim() == 4:
        idx = seed_idx[:, None, :, None].expand(-1, 1, -1, 4)
        boxes = prev_boxes.gather(1, idx)[:, 0]
    else:
        boxes = prev_boxes.gather(1, seed_idx[..., None].expand(-1, -1, 4))
    valid = labels > 0.5
    return PseudoTargets(boxes=boxes, valid=valid, weights=img_evidence,
                         scores=torch.where(valid, seed_score, 0.0))


class ProposalTargets(NamedTuple):
    """Per-proposal supervision of one refinement branch."""

    gt_class: torch.Tensor  # (B, P) int64 in [0, C] (C: background), -1 ignore
    weight: torch.Tensor    # (B, P) float
    gt_box: torch.Tensor    # (B, P, 4) matched pseudo box (for box regression)


def label_proposals(pgt: PseudoTargets, proposals: torch.Tensor,
                    prop_mask: torch.Tensor, iou_thresholds=(0.5,),
                    iou_labels=(0, 1)) -> ProposalTargets:
    """Match proposals (B, P, 4) to the mined pseudo ground truth."""
    C = pgt.valid.shape[-1]
    quality = box_ops.pairwise_iou(pgt.boxes, proposals)          # (B, C, P)
    midx, mlab = match(quality, pgt.valid, list(iou_thresholds),
                       list(iou_labels))
    gt_class = torch.where(mlab == 1, midx, C)
    gt_class = torch.where(mlab == -1, -1, gt_class)
    gt_class = torch.where(prop_mask, gt_class, -1)
    weight = torch.where(gt_class >= 0, pgt.weights.gather(1, midx), 0.0)
    gt_box = pgt.boxes.gather(1, midx[..., None].expand(-1, -1, 4))
    return ProposalTargets(gt_class=gt_class, weight=weight, gt_box=gt_box)


def refinement_loss(cls_logits: torch.Tensor,
                    targets: ProposalTargets) -> torch.Tensor:
    """Weighted cross-entropy over the batch, over the proposals of weight
    above 1e-12 (of the global batch under a mesh shard).
    cls_logits: (B, P, C+1)."""
    logp = torch.log_softmax(cls_logits, dim=-1)
    cls = targets.gt_class.clamp(min=0)
    ce = -logp.gather(-1, cls[..., None])[..., 0]
    ce = torch.where(targets.gt_class >= 0, ce, 0.0)
    w = targets.weight
    valid = (w > 1e-12).float()
    return (ce * w).sum() / context.global_sum(valid.sum()).clamp(min=1.0)


def refinement_box_loss(deltas: torch.Tensor, proposals: torch.Tensor,
                        targets: ProposalTargets, prop_mask: torch.Tensor,
                        num_classes: int,
                        reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0),
                        smooth_l1_beta: float = 0.0) -> torch.Tensor:
    """Smooth-L1 (L1 at beta 0) regression against the matched pseudo boxes,
    foreground proposals only, divided by the number of valid proposals
    (of the global batch under a mesh shard).
    deltas: (B, P, R*4); proposals: (B, P, 4)."""
    B, P = targets.gt_class.shape
    fg = (targets.gt_class >= 0) & (targets.gt_class < num_classes)
    gt_deltas = box_ops.get_deltas(proposals, targets.gt_box, reg_weights)
    R = deltas.shape[-1] // 4
    d = deltas.reshape(B, P, R, 4)
    cls_idx = targets.gt_class.clamp(0, R - 1)
    pred = d.gather(2, cls_idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    diff = (pred - gt_deltas).abs()
    if smooth_l1_beta > 0:
        loss = torch.where(diff < smooth_l1_beta,
                           0.5 * diff ** 2 / smooth_l1_beta,
                           diff - 0.5 * smooth_l1_beta)
    else:
        loss = diff
    loss = torch.where(fg[..., None], loss, 0.0)
    return loss.sum() / context.global_sum(
        prop_mask.float().sum()).clamp(min=1.0)


def branch_probs(cls_logits: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities over K+1 classes; (B, P, C+1)."""
    return torch.softmax(cls_logits, dim=-1)


def average_branch_probs(cls_logits_list: Sequence[torch.Tensor]
                         ) -> torch.Tensor:
    """Inference-time mean of the branch softmaxes."""
    probs = [torch.softmax(lg, dim=-1) for lg in cls_logits_list]
    return sum(probs) / len(probs)
