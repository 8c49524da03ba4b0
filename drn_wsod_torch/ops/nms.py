"""Static-shape multi-class NMS (counterpart of
``drn_wsod_tpu/ops/nms.py:multiclass_nms``), batched over images.

Greedy NMS is the fixed point of

    keep[i] = cand[i] and not any_j(keep[j] and j ranks before i
                                    and IoU(i, j) > thresh)

run here, as in the JAX package, for a fixed number of Jacobi rounds from
``keep = cand``. Entries whose suppression chain is deeper than the round
count are not exact greedy NMS; the port copies that behaviour.

Orderings follow ``jax.lax.top_k``, which puts the lower index first among
equal values: ``torch.topk`` promises no order on ties, so every top-k here
is a stable descending sort, sliced.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..structures.boxes import pairwise_iou


def _top(x: torch.Tensor, k: int):
    """Top-k along the last dim, ties to the lower index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, iou: Optional[torch.Tensor] = None,
             max_iters: Optional[int] = None) -> torch.Tensor:
    """Greedy NMS keep-mask (counterpart of
    ``drn_wsod_tpu/ops/nms.py:nms_mask``), batched over leading dims.

    Args:
      boxes: (..., N, 4) XYXY.
      scores: (..., N).
      valid: (..., N) bool candidates; padded slots False.
      iou_threshold: a pair above it (strictly) suppresses.
      iou: optional precomputed (..., N, N) IoU matrix; broadcasts against
        the leading dims of ``scores``.
      max_iters: Jacobi rounds, min(32, N) by default.

    Ranks are a stable ascending sort of ``-scores`` with invalid slots
    last, as ``jnp.argsort(-s, stable=True)`` ranks them.

    Returns: (..., N) bool keep mask.
    """
    if iou is None:
        iou = pairwise_iou(boxes, boxes)
    n = boxes.shape[-2]
    iters = max_iters if max_iters is not None else min(32, n)
    s = torch.where(valid, scores, scores.new_full((), -math.inf))
    order = torch.sort(-s, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=order.device).expand_as(order))
    earlier = rank[..., None, :] < rank[..., :, None]       # j strictly before i
    sup = ((iou > iou_threshold) & earlier & valid[..., None, :]
           & valid[..., :, None]).to(torch.float32)
    keep = valid
    for _ in range(iters):
        hit = torch.matmul(sup, keep.to(torch.float32)[..., None])[..., 0]
        keep = valid & ~(hit > 0.5)
    return keep


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, iou_threshold: float,
                   score_threshold: float, topk: int,
                   per_class_topk: int = 1024,
                   nms_iters: int = 16) -> Dict[str, torch.Tensor]:
    """Per-class NMS over all classes, then a global top-k, per image.

    Args:
      boxes: (B, P, 4) class-agnostic or (B, P, C, 4) class-specific boxes.
      scores: (B, P, C) class scores without the background column.
      valid: (B, P) bool proposal mask.
      topk: number of output slots per image.

    Candidates are trimmed to each class's top ``per_class_topk`` first;
    suppression (strict ``>`` IoU) runs ``nms_iters`` Jacobi rounds.

    Returns a dict of boxes (B, topk, 4), scores (B, topk), classes
    (B, topk) int64 and valid (B, topk) bool; padded entries have score 0,
    zero boxes and valid False.
    """
    B, P, C = scores.shape
    class_specific = boxes.dim() == 4
    T = min(per_class_topk, P)
    # a fill on the device: torch.tensor(..., device=cuda) copies from
    # pageable host memory, which waits for all work queued on the stream
    neg = scores.new_full((), -math.inf)

    s = torch.where(valid[..., None] & torch.isfinite(scores)
                    & (scores > score_threshold), scores, neg)
    if class_specific:
        s = torch.where(torch.isfinite(boxes).all(-1), s, neg)
    top_s, top_i = _top(s.transpose(1, 2), T)                  # (B, C, T)

    per_class = (boxes.permute(0, 2, 1, 3) if class_specific
                 else boxes[:, None].expand(B, C, P, 4))       # (B, C, P, 4)
    boxes_c = torch.gather(per_class, 2,
                           top_i[..., None].expand(B, C, T, 4))  # (B, C, T, 4)

    iou = pairwise_iou(boxes_c, boxes_c)                       # (B, C, T, T)
    cand = torch.isfinite(top_s)
    earlier = torch.ones(T, T, dtype=torch.bool,
                         device=scores.device).tril(-1)        # j < i (sorted)
    sup = ((iou > iou_threshold) & earlier & cand[..., None, :]
           & cand[..., :, None]).to(torch.float32)
    keep = cand
    for _ in range(min(nms_iters, T)):
        # sup and keep are 0/1: the float32 product counts suppressors
        hit = torch.matmul(sup, keep.to(torch.float32)[..., None])[..., 0]
        keep = cand & (hit < 0.5)

    kept = torch.where(keep, top_s, neg).reshape(B, C * T)
    k = min(topk, C * T)
    out_s, flat = _top(kept, k)
    if k < topk:
        out_s = torch.cat([out_s, neg.expand(B, topk - k)], dim=1)
        flat = torch.cat([flat, flat.new_zeros(B, topk - k)], dim=1)
    out_boxes = torch.gather(boxes_c.reshape(B, C * T, 4), 1,
                             flat[..., None].expand(B, topk, 4))
    out_valid = torch.isfinite(out_s)
    return {
        "boxes": torch.where(out_valid[..., None], out_boxes, 0.0),
        "scores": torch.where(out_valid, out_s, 0.0),
        "classes": flat // T,
        "valid": out_valid,
    }
