"""Semantic segmentation evaluation, mIoU, fwIoU, pACC and mACC
(counterpart of ``drn_wsod_tpu/evaluation/sem_seg_eval.py``): an
(N+1, N+1) confusion matrix over (prediction, GT) label maps, the extra
row and column holding the ignore label, and the standard metrics from
it, in float64 numpy as the JAX package computes them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class SemSegEvaluator:
    """The detection evaluators' protocol: reset / process_single /
    state_dict / merge_states / evaluate."""

    def __init__(self, class_names: Sequence[str],
                 ignore_label: int = 255):
        self._names = list(class_names)
        self._num = len(self._names)
        self._ignore = ignore_label
        self.reset()

    def reset(self):
        n = self._num + 1
        self._conf = np.zeros((n, n), np.int64)

    def process_single(self, pred: np.ndarray, gt: np.ndarray):
        """pred: (H, W) int predicted class ids; gt: (H, W) int labels with
        ``ignore_label`` for void pixels."""
        pred = np.asarray(pred, np.int64).reshape(-1)
        gt = np.asarray(gt, np.int64).reshape(-1)
        gt = np.where(gt == self._ignore, self._num, gt)
        pred = np.clip(pred, 0, self._num)
        self._conf += np.bincount(
            (self._num + 1) * pred + gt,
            minlength=self._conf.size).reshape(self._conf.shape)

    def state_dict(self):
        return {"conf": self._conf}

    def merge_states(self, states):
        for s in states:
            self._conf += np.asarray(s["conf"], np.int64)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        """Reference metric definitions (sem_seg_evaluation.py:evaluate):
        IoU per class over non-ignored pixels; mIoU mean over classes with
        GT pixels; fwIoU frequency-weighted; pACC overall pixel accuracy;
        mACC mean per-class accuracy."""
        acc = np.full(self._num, np.nan)
        iou = np.full(self._num, np.nan)
        tp = self._conf.diagonal()[:-1].astype(np.float64)
        pos_gt = self._conf[:-1, :-1].sum(axis=0).astype(np.float64)
        pos_pred = self._conf[:-1, :-1].sum(axis=1).astype(np.float64)
        class_weights = pos_gt / max(pos_gt.sum(), 1)
        valid = pos_gt > 0
        acc[valid] = tp[valid] / pos_gt[valid]
        union = pos_gt + pos_pred - tp
        iou_valid = (pos_gt + pos_pred) > 0
        iou[iou_valid] = tp[iou_valid] / np.maximum(union[iou_valid], 1)
        miou = float(np.sum(iou[iou_valid]) / max(iou_valid.sum(), 1))
        fiou = float(np.sum(iou[iou_valid] * class_weights[iou_valid]))
        pacc = float(tp.sum() / max(pos_gt.sum(), 1))
        macc = float(np.sum(acc[valid]) / max(valid.sum(), 1))
        res = {"mIoU": 100 * miou, "fwIoU": 100 * fiou,
               "pACC": 100 * pacc, "mACC": 100 * macc}
        for i, name in enumerate(self._names):
            res[f"IoU-{name}"] = 100 * float(iou[i]) \
                if np.isfinite(iou[i]) else float("nan")
        return {"sem_seg": res}
