"""COCO-style box AP (counterpart of the box arm of
``drn_wsod_tpu/evaluation/coco_eval.py``): AP over IoU 0.50:0.95 with
101-point recall interpolation, per area range, at most 100 detections an
image, from in-memory arrays, in float64 numpy as in the JAX package.

The matcher follows COCOeval's rules: detections by descending score take
the best remaining GT at IoU >= the threshold, a non-ignored GT before an
ignored one; crowd and difficult GT, and GT outside the area range, are
ignored, and so is a detection outside the range that matched nothing.
The instance-mask ("segm") and keypoint tasks are not ported.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


def _nanmean(a) -> float:
    """The mean of the values that are not NaN; NaN if there are none."""
    a = np.asarray(a, np.float64).ravel()
    m = ~np.isnan(a)
    return float(a[m].mean()) if m.any() else float("nan")


IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _iou_matrix(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a_d = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    a_g = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = a_d[:, None] + a_g[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_image(det_boxes, det_scores, gt_boxes, gt_ignore, iou_thrs,
                 max_det):
    """Greedy matching of one image's top ``max_det`` detections: (tp (T,
    D), ignored (T, D), their scores (D,))."""
    order = np.argsort(-det_scores, kind="stable")[:max_det]
    ious = _iou_matrix(det_boxes[order], gt_boxes)
    tp, ign = _match_from_ious(ious, gt_ignore, iou_thrs)
    return tp, ign, det_scores[order]


def _match_from_ious(ious, gt_ignore, iou_thrs):
    """Greedy COCOeval matching from a (D, G) IoU matrix whose detections
    are sorted by descending score."""
    D, G = ious.shape
    tp = np.zeros((len(iou_thrs), D), dtype=bool)
    ign = np.zeros((len(iou_thrs), D), dtype=bool)
    for t, thr in enumerate(iou_thrs):
        taken = np.zeros(G, dtype=bool)
        for d in range(D):
            best, best_iou = -1, thr
            for g in range(G):
                if taken[g] and not gt_ignore[g]:
                    continue
                if ious[d, g] >= best_iou:
                    if best > -1 and not gt_ignore[best] and gt_ignore[g]:
                        continue
                    best, best_iou = g, ious[d, g]
            if best > -1:
                if gt_ignore[best]:
                    ign[t, d] = True
                else:
                    tp[t, d] = True
                    taken[best] = True
    return tp, ign


def _average_precision(tp, ign, scores, npos):
    """101-point interpolated AP for each IoU threshold (NaN without
    positives)."""
    aps = np.full(tp.shape[0], np.nan)
    if npos == 0:
        return aps
    for t in range(tp.shape[0]):
        keep = ~ign[t]
        order = np.argsort(-scores[keep], kind="stable")
        tps = tp[t][keep][order]
        tp_cum = np.cumsum(tps)
        fp_cum = np.cumsum(~tps)
        rec = tp_cum / npos
        prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
        for i in range(len(prec) - 1, 0, -1):       # precision envelope
            prec[i - 1] = max(prec[i - 1], prec[i])
        idx = np.searchsorted(rec, RECALL_THRS, side="left")
        p = np.zeros(len(RECALL_THRS))
        valid = idx < len(prec)
        p[valid] = prec[idx[valid]]
        aps[t] = p.mean()
    return aps


def _box_areas(boxes: np.ndarray) -> np.ndarray:
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


class COCODetectionEvaluator:
    """COCO box AP with the VOC evaluator's ``reset`` / ``process_single``
    / ``evaluate`` API. ``gt_by_image`` maps str(image_id) to the record's
    annotations (contiguous ``category_id``, XYXY ``bbox``, ``difficult``).
    Only the "bbox" task is ported: "segm" and "keypoints" raise."""

    def __init__(self, class_names: Sequence[str],
                 gt_by_image: Dict[str, List[dict]],
                 tasks: Sequence[str] = ("bbox",)):
        dense = [t for t in tasks if t != "bbox"]
        if dense:
            raise NotImplementedError(
                f"COCO evaluator tasks {dense}: instance-mask and keypoint "
                "AP are not ported yet: ROADMAP.md queue 1, item 14 "
                "(the mask and keypoint arms)")
        self._class_names = list(class_names)
        self._gt = gt_by_image
        self._tasks = tuple(tasks)
        self.reset()

    def reset(self):
        self._dets = defaultdict(lambda: defaultdict(list))  # cls -> img -> []

    def process_single(self, image_id: str, boxes, scores, classes,
                       valid=None):
        for i in range(len(scores)):
            if valid is not None and not valid[i]:
                continue
            self._dets[int(classes[i])][image_id].append(
                (float(scores[i]), *[float(v) for v in boxes[i]]))

    def state_dict(self):
        """The accumulated detections, picklable, in the JAX package's
        layout (an empty "dense" part)."""
        return {"box": {c: {img: list(d) for img, d in per.items()}
                        for c, per in self._dets.items()},
                "dense": {}}

    def merge_states(self, states):
        for st in states:
            box = st.get("box", {}) if ("box" in st or "dense" in st) else st
            for c, per in box.items():
                for img, d in per.items():
                    self._dets[int(c)][img].extend(d)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        per_class_ap = {}     # area -> (C, T)
        for area_name, (lo, hi) in AREA_RANGES.items():
            ap_list = []
            for cls_id, _ in enumerate(self._class_names):
                tps, igns, scs = [], [], []
                npos = 0
                for image_id, annos in self._gt.items():
                    gt = [a for a in annos if a["category_id"] == cls_id]
                    gt_boxes = np.array([a["bbox"] for a in gt],
                                        dtype=np.float64).reshape(-1, 4)
                    areas = _box_areas(gt_boxes)
                    gt_ignore = np.array(
                        [bool(a.get("difficult", 0)) for a in gt],
                        dtype=bool) | (areas < lo) | (areas >= hi)
                    npos += int((~gt_ignore).sum())
                    d = self._dets[cls_id].get(image_id, [])
                    if not d and len(gt) == 0:
                        continue
                    d = np.array(d, dtype=np.float64).reshape(-1, 5)
                    tp, ign, s = _match_image(d[:, 1:], d[:, 0], gt_boxes,
                                              gt_ignore, IOU_THRS, MAX_DETS)
                    d_areas = _box_areas(d[:, 1:])
                    oob = ((d_areas < lo) | (d_areas >= hi))[
                        np.argsort(-d[:, 0], kind="stable")[:MAX_DETS]]
                    ign = ign | (oob[None, :] & ~tp)
                    tps.append(tp)
                    igns.append(ign)
                    scs.append(s)
                if tps:
                    ap_list.append(_average_precision(
                        np.concatenate(tps, axis=1),
                        np.concatenate(igns, axis=1), np.concatenate(scs),
                        npos))
                else:
                    ap_list.append(np.full(len(IOU_THRS), np.nan))
            per_class_ap[area_name] = np.stack(ap_list)

        ap_all = per_class_ap["all"]
        return {"bbox": {
            "AP": float(_nanmean(ap_all) * 100),
            "AP50": float(_nanmean(ap_all[:, 0]) * 100),
            "AP75": float(_nanmean(ap_all[:, 5]) * 100),
            "APs": float(_nanmean(per_class_ap["small"]) * 100),
            "APm": float(_nanmean(per_class_ap["medium"]) * 100),
            "APl": float(_nanmean(per_class_ap["large"]) * 100),
        }}
