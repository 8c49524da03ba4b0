"""Panoptic fusion and Panoptic Quality (counterpart of
``drn_wsod_tpu/evaluation/panoptic_eval.py``), host numpy:

  * ``combine_semantic_and_instance_outputs``: PanopticFPN's fusion
    heuristic: instance masks painted in score order, those mostly under
    earlier ones skipped, then the remaining area filled with the stuff
    segments above an area limit;
  * ``PanopticQualityEvaluator``: segments match where their IoU exceeds
    0.5 (unique by construction), the union leaving out the prediction's
    part on GT void; PQ = sum IoU_TP / (|TP| + |FP| / 2 + |FN| / 2), SQ =
    sum IoU_TP / |TP|, RQ = |TP| / (|TP| + |FP| / 2 + |FN| / 2), averaged
    over the categories that occur; a prediction mostly on void is not a
    false positive.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

VOID = 0  # segment id 0 = unlabeled in both prediction and GT maps


def combine_semantic_and_instance_outputs(
    instance_masks: np.ndarray,
    scores: np.ndarray,
    classes: np.ndarray,
    sem_seg: np.ndarray,
    overlap_threshold: float = 0.5,
    stuff_area_limit: int = 4096,
    instances_confidence_threshold: float = 0.5,
) -> Tuple[np.ndarray, List[dict]]:
    """Fuse instance masks + semantic map into a panoptic id map.

    Args:
      instance_masks: (N, H, W) bool.
      scores/classes: (N,).
      sem_seg: (H, W) int contiguous semantic ids; 0 is the special
        "thing" class.

    Returns (panoptic_seg (H, W) int32 segment ids, segments_info).
    """
    panoptic = np.zeros(sem_seg.shape, np.int32)
    segments: List[dict] = []
    seg_id = 0

    for idx in np.argsort(-np.asarray(scores)):
        score = float(scores[idx])
        if score < instances_confidence_threshold:
            break
        mask = np.asarray(instance_masks[idx], bool)
        area = int(mask.sum())
        if area == 0:
            continue
        intersect = mask & (panoptic > 0)
        if intersect.sum() / area > overlap_threshold:
            continue
        mask = mask & (panoptic == 0)
        seg_id += 1
        panoptic[mask] = seg_id
        segments.append({"id": seg_id, "isthing": True, "score": score,
                         "category_id": int(classes[idx]),
                         "instance_id": int(idx)})

    for sem_label in np.unique(sem_seg):
        if sem_label == 0:      # special "thing" class
            continue
        mask = (sem_seg == sem_label) & (panoptic == 0)
        area = int(mask.sum())
        if area < stuff_area_limit:
            continue
        seg_id += 1
        panoptic[mask] = seg_id
        segments.append({"id": seg_id, "isthing": False,
                         "category_id": int(sem_label), "area": area})
    return panoptic, segments


def _segment_areas(seg_map, infos):
    cats = {s["id"]: s["category_id"] for s in infos}
    ids, counts = np.unique(seg_map, return_counts=True)
    return {int(i): int(c) for i, c in zip(ids, counts) if i != VOID}, cats


class PanopticQualityEvaluator:
    """PQ, SQ and RQ accumulated over (pred, gt) panoptic maps and their
    segment infos; the other evaluators' protocol (reset / process_single
    / state_dict / merge_states / evaluate)."""

    def __init__(self, num_categories: int):
        self._num = num_categories
        self.reset()

    def reset(self):
        n = self._num
        self._iou = np.zeros(n)
        self._tp = np.zeros(n, np.int64)
        self._fp = np.zeros(n, np.int64)
        self._fn = np.zeros(n, np.int64)

    def process_single(self, pred_map: np.ndarray, pred_infos: List[dict],
                       gt_map: np.ndarray, gt_infos: List[dict]):
        pred_map = np.asarray(pred_map, np.int64)
        gt_map = np.asarray(gt_map, np.int64)
        pred_areas, pred_cats = _segment_areas(pred_map, pred_infos)
        gt_areas, gt_cats = _segment_areas(gt_map, gt_infos)

        # pairwise intersections via a combined key histogram
        offset = int(pred_map.max()) + 1
        combo = gt_map * offset + pred_map
        keys, counts = np.unique(combo, return_counts=True)
        inter: Dict[Tuple[int, int], int] = {}
        for k, c in zip(keys, counts):
            g, p = int(k) // offset, int(k) % offset
            inter[(g, p)] = int(c)

        matched_gt, matched_pred = set(), set()
        for (g, p), i in inter.items():
            if g == VOID or p == VOID:
                continue
            if gt_cats.get(g) != pred_cats.get(p):
                continue
            # panopticapi union rule: exclude the pred area lying on GT void
            union = (gt_areas[g] + pred_areas[p] - i
                     - inter.get((VOID, p), 0))
            iou = i / max(union, 1)
            if iou > 0.5:
                c = gt_cats[g]
                self._iou[c] += iou
                self._tp[c] += 1
                matched_gt.add(g)
                matched_pred.add(p)

        for g, a in gt_areas.items():
            if g not in matched_gt:
                self._fn[gt_cats[g]] += 1
        for p, a in pred_areas.items():
            if p in matched_pred:
                continue
            # preds mostly covering GT void are ignored (panopticapi rule)
            void_part = inter.get((VOID, p), 0)
            if void_part / max(a, 1) > 0.5:
                continue
            self._fp[pred_cats[p]] += 1

    def state_dict(self):
        return {"iou": self._iou, "tp": self._tp, "fp": self._fp,
                "fn": self._fn}

    def merge_states(self, states):
        for s in states:
            self._iou += s["iou"]
            self._tp += s["tp"]
            self._fp += s["fp"]
            self._fn += s["fn"]

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        denom = self._tp + self._fp / 2.0 + self._fn / 2.0
        valid = denom > 0
        pq = np.zeros(self._num)
        sq = np.zeros(self._num)
        rq = np.zeros(self._num)
        pq[valid] = self._iou[valid] / denom[valid]
        sq[self._tp > 0] = self._iou[self._tp > 0] / self._tp[self._tp > 0]
        rq[valid] = self._tp[valid] / denom[valid]
        n = max(int(valid.sum()), 1)
        return {"panoptic_seg": {
            "PQ": 100 * float(pq[valid].sum()) / n,
            "SQ": 100 * float(sq[valid].sum()) / n,
            "RQ": 100 * float(rq[valid].sum()) / n,
            "N": int(valid.sum()),
        }}
