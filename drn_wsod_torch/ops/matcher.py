"""IoU matcher as a masked tensor op (counterpart of
``drn_wsod_tpu/ops/matcher.py:match``).

Each prediction gets the best-overlapping ground-truth index and a label
from IoU thresholds. Ground-truth validity is a mask over padded slots.
Leading dimensions batch (the JAX function is 2-D and vmapped).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def match(quality: torch.Tensor, gt_valid: torch.Tensor,
          thresholds: Sequence[float], labels: Sequence[int],
          allow_low_quality: bool = False
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Match predictions to (padded) ground truth.

    Args:
      quality: (..., M, N) pairwise quality (IoU), ground truth x predictions.
      gt_valid: (..., M) bool mask of real ground-truth rows.
      thresholds: ascending thresholds, e.g. [0.5].
      labels: len(thresholds) + 1 labels in {-1, 0, 1}, one per bin.
      allow_low_quality: also label ``labels[-1]`` every prediction that
        reaches some valid ground truth's maximum quality (ties included),
        when that maximum is above 0.

    Returns:
      matched_idx: (..., N) int64, the first ground-truth index of maximum
        quality; 0 where no ground truth is valid.
      matched_label: (..., N) int64 bin labels; ``labels[0]`` everywhere
        where no ground truth is valid.
    """
    assert len(labels) == len(thresholds) + 1
    q = torch.where(gt_valid[..., :, None], quality,
                    quality.new_full((), -1.0))
    matched_vals, matched_idx = q.max(dim=-2)

    matched_label = torch.full_like(matched_idx, labels[0])
    for thr, lab in zip(thresholds, labels[1:]):
        matched_label = torch.where(matched_vals >= thr,
                                    matched_label.new_full((), lab),
                                    matched_label)

    if allow_low_quality:
        per_gt_max = q.amax(dim=-1, keepdim=True)               # (..., M, 1)
        is_best = (q >= per_gt_max) & (per_gt_max > 0)
        best_any = (is_best & gt_valid[..., :, None]).any(dim=-2)
        matched_label = torch.where(best_any,
                                    matched_label.new_full((), labels[-1]),
                                    matched_label)

    any_gt = gt_valid.any(dim=-1, keepdim=True)
    matched_idx = torch.where(any_gt, matched_idx, 0)
    matched_label = torch.where(any_gt, matched_label,
                                matched_label.new_full((), labels[0]))
    return matched_idx, matched_label
