"""COCO-style AP (counterpart of ``drn_wsod_tpu/evaluation/coco_eval.py``):
AP over IoU 0.50:0.95 with 101-point recall interpolation, per area range,
at most 100 detections an image, from in-memory arrays, in float64 numpy as
in the JAX package: box AP always, instance-mask AP ("segm") and keypoint
AP ("keypoints", object keypoint similarity) where the tasks name them.

The matcher follows COCOeval's rules: detections by descending score take
the best remaining GT at IoU >= the threshold, a non-ignored GT before an
ignored one; crowd and difficult GT, and GT outside the area range, are
ignored, and so is a detection outside the range that matched nothing.
The dense tasks match the same way on mask IoU (detections' masks as
uncompressed RLE, GT polygons filled by ``structures/masks.py:
rasterize_polygons``, GT RLE decoded) or on OKS; a keypoint GT with none
visible is ignored. As in the JAX package, ``rle_decode`` takes only list
``counts``: COCO's compressed string counts raise ``TypeError``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from ..structures.masks import rasterize_polygons


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
                 max_det, iou_fn=_iou_matrix):
    """Greedy matching of one image's top ``max_det`` detections on
    ``iou_fn``'s (D, G) IoU: (tp (T, D), ignored (T, D), their scores
    (D,))."""
    order = np.argsort(-det_scores, kind="stable")[:max_det]
    ious = iou_fn(det_boxes[order], gt_boxes)
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


# COCO's person-keypoint sigmas (pycocotools cocoeval.py kpt_oks_sigmas)
COCO_KPT_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62,
     1.07, 1.07, .87, .87, .89, .89]) / 10.0


def rle_encode(mask) -> dict:
    """(H, W) mask (> 0.5 is foreground) -> COCO uncompressed RLE: the
    column-major runs, starting with background."""
    m = np.asarray(mask) > 0.5
    h, w = m.shape
    flat = m.T.reshape(-1)
    if flat.size == 0:
        return {"size": [int(h), int(w)], "counts": [0]}
    changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.concatenate([[0], changes, [flat.size]])
    counts = np.diff(bounds).tolist()
    if flat[0]:
        counts = [0] + counts
    return {"size": [int(h), int(w)], "counts": [int(c) for c in counts]}


def rle_decode(rle: dict) -> np.ndarray:
    """Uncompressed RLE -> (H, W) bool."""
    h, w = rle["size"]
    flat = np.zeros(h * w, dtype=bool)
    pos, val = 0, False
    for c in rle["counts"]:
        flat[pos:pos + c] = val
        pos += c
        val = not val
    return flat.reshape(w, h).T


def rle_area(rle: dict) -> int:
    return int(sum(rle["counts"][1::2]))


def gt_segmentation_mask(seg, h: int, w: int) -> np.ndarray:
    """A GT "segmentation" (polygon list, or uncompressed RLE padded or
    cropped to (h, w)) -> (h, w) bool."""
    if isinstance(seg, dict):
        m = rle_decode(seg)
        if m.shape != (h, w):
            out = np.zeros((h, w), dtype=bool)
            out[:m.shape[0], :m.shape[1]] = m[:h, :w]
            return out
        return m
    return rasterize_polygons(seg, h, w)


def _mask_iou_matrix(det_masks, gt_masks) -> np.ndarray:
    D, G = len(det_masks), len(gt_masks)
    ious = np.zeros((D, G))
    for d in range(D):
        dm = det_masks[d]
        for g in range(G):
            inter = np.logical_and(dm, gt_masks[g]).sum()
            union = np.logical_or(dm, gt_masks[g]).sum()
            ious[d, g] = inter / union if union else 0.0
    return ious


def _oks_matrix(det_kpts, gt_kpts, gt_areas, sigmas) -> np.ndarray:
    """(D, K, 3) x (G, K, 3) -> (D, G) object keypoint similarity over
    each GT's visible keypoints (pycocotools ``computeOks``); 0 for a GT
    with none visible."""
    D, G = len(det_kpts), len(gt_kpts)
    ious = np.zeros((D, G))
    if D == 0 or G == 0:
        return ious
    K = min(det_kpts.shape[1], gt_kpts.shape[1])
    var = (2.0 * np.asarray(sigmas[:K], np.float64)) ** 2
    for g in range(G):
        vis = gt_kpts[g, :K, 2] > 0
        if not vis.any():
            continue
        dx = det_kpts[:, :K, 0] - gt_kpts[g, None, :K, 0]
        dy = det_kpts[:, :K, 1] - gt_kpts[g, None, :K, 1]
        e = (dx ** 2 + dy ** 2) / var[None, :] / (
            2.0 * (gt_areas[g] + np.spacing(1)))
        ious[:, g] = np.exp(-e[:, vis]).sum(axis=1) / vis.sum()
    return ious


def _anno_area(a) -> float:
    if "area" in a and a["area"] is not None:
        return float(a["area"])
    b = a["bbox"]
    return float(max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0))


def _summary(per_area: Dict[str, np.ndarray]) -> Dict[str, float]:
    ap_all = per_area["all"]
    return {
        "AP": float(_nanmean(ap_all) * 100),
        "AP50": float(_nanmean(ap_all[:, 0]) * 100),
        "AP75": float(_nanmean(ap_all[:, 5]) * 100),
        "APs": float(_nanmean(per_area["small"]) * 100),
        "APm": float(_nanmean(per_area["medium"]) * 100),
        "APl": float(_nanmean(per_area["large"]) * 100),
    }


class COCODetectionEvaluator:
    """COCO AP with the VOC evaluator's ``reset`` / ``process_single`` /
    ``evaluate`` API. ``gt_by_image`` maps str(image_id) to the record's
    annotations (contiguous ``category_id``, XYXY ``bbox``, ``difficult``,
    and for the dense tasks ``iscrowd``, ``area``, ``segmentation``,
    ``keypoints``). "bbox" is always computed; ``tasks`` may add "segm"
    (``process_single`` then takes each detection's (H, W) mask at the
    original size) and "keypoints" (its (K, 3) keypoints), scored with
    COCO's person sigmas ``COCO_KPT_SIGMAS``."""

    def __init__(self, class_names: Sequence[str],
                 gt_by_image: Dict[str, List[dict]],
                 tasks: Sequence[str] = ("bbox",)):
        self._class_names = list(class_names)
        self._gt = gt_by_image
        self._tasks = tuple(tasks)
        self.reset()

    def reset(self):
        self._dets = defaultdict(lambda: defaultdict(list))  # cls -> img -> []
        # cls -> img -> [{"score", "bbox", "segm" (RLE), "kpts"}]
        self._dense = defaultdict(lambda: defaultdict(list))

    def process_single(self, image_id: str, boxes, scores, classes,
                       valid=None, masks=None, keypoints=None):
        """masks: optional (D, H, W) binary masks at the original size;
        keypoints: optional (D, K, 3) (x, y, score)."""
        for i in range(len(scores)):
            if valid is not None and not valid[i]:
                continue
            c = int(classes[i])
            self._dets[c][image_id].append(
                (float(scores[i]), *[float(v) for v in boxes[i]]))
            if masks is not None or keypoints is not None:
                entry = {"score": float(scores[i]),
                         "bbox": [float(v) for v in boxes[i]]}
                if masks is not None:
                    entry["segm"] = rle_encode(masks[i])
                if keypoints is not None:
                    entry["kpts"] = np.asarray(keypoints[i],
                                               np.float64).tolist()
                self._dense[c][image_id].append(entry)

    def state_dict(self):
        """The accumulated detections, picklable, in the JAX package's
        layout."""
        return {"box": {c: {img: list(d) for img, d in per.items()}
                        for c, per in self._dets.items()},
                "dense": {c: {img: list(d) for img, d in per.items()}
                          for c, per in self._dense.items()}}

    def merge_states(self, states):
        for st in states:
            if "box" in st or "dense" in st:
                box, dense = st.get("box", {}), st.get("dense", {})
            else:                      # a box-only state of the old layout
                box, dense = st, {}
            for c, per in box.items():
                for img, d in per.items():
                    self._dets[int(c)][img].extend(d)
            for c, per in dense.items():
                for img, d in per.items():
                    self._dense[int(c)][img].extend(d)

    # the box geometry: XYXY here, (cx, cy, w, h, angle) in the rotated
    # evaluator (``rotated_coco_eval.py``)
    _box_dim = 4
    _iou_fn = staticmethod(_iou_matrix)

    @staticmethod
    def _box_areas(boxes: np.ndarray) -> np.ndarray:
        return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        per_class_ap = {}     # area -> (C, T)
        bd = self._box_dim
        for area_name, (lo, hi) in AREA_RANGES.items():
            ap_list = []
            for cls_id, _ in enumerate(self._class_names):
                tps, igns, scs = [], [], []
                npos = 0
                for image_id, annos in self._gt.items():
                    gt = [a for a in annos if a["category_id"] == cls_id]
                    gt_boxes = np.array([a["bbox"] for a in gt],
                                        dtype=np.float64).reshape(-1, bd)
                    areas = self._box_areas(gt_boxes)
                    gt_ignore = np.array(
                        [bool(a.get("difficult", 0)) for a in gt],
                        dtype=bool) | (areas < lo) | (areas >= hi)
                    npos += int((~gt_ignore).sum())
                    d = self._dets[cls_id].get(image_id, [])
                    if not d and len(gt) == 0:
                        continue
                    d = np.array(d, dtype=np.float64).reshape(-1, 1 + bd)
                    tp, ign, s = _match_image(d[:, 1:], d[:, 0], gt_boxes,
                                              gt_ignore, IOU_THRS, MAX_DETS,
                                              self._iou_fn)
                    d_areas = self._box_areas(d[:, 1:])
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

        results = {"bbox": _summary(per_class_ap)}
        for task in self._tasks:
            if task != "bbox":
                results[task] = self._evaluate_dense_task(task)
        return results

    def _evaluate_dense_task(self, task: str) -> Dict[str, float]:
        """Mask AP ("segm") or keypoint OKS AP ("keypoints") over the
        dense store, matched by the box rules on mask IoU or OKS. A
        detection's area is its mask's (segm) or its box's (keypoints);
        a GT's is its "area", else its box's."""
        key = "segm" if task == "segm" else "kpts"
        per_area = {}
        for area_name, (lo, hi) in AREA_RANGES.items():
            ap_list = []
            for cls_id, _ in enumerate(self._class_names):
                tps, igns, scs = [], [], []
                npos = 0
                for image_id, annos in self._gt.items():
                    gt = [a for a in annos if a["category_id"] == cls_id]
                    if task == "segm":
                        gt = [a for a in gt if a.get("segmentation")
                              is not None and a.get("segmentation") != []]
                    d = [e for e in self._dense[cls_id].get(image_id, [])
                         if key in e]
                    if not d and not gt:
                        continue
                    d.sort(key=lambda e: -e["score"])
                    d = d[:MAX_DETS]
                    scores = np.array([e["score"] for e in d])

                    gt_areas = np.array([_anno_area(a) for a in gt])
                    gt_ignore = np.array(
                        [bool(a.get("difficult", 0)) or
                         bool(a.get("iscrowd", 0)) for a in gt], dtype=bool)
                    if task == "keypoints":
                        nvis = np.array([
                            (np.asarray(a.get("keypoints", []),
                                        np.float64).reshape(-1, 3)[:, 2] > 0
                             ).sum() if a.get("keypoints") else 0
                            for a in gt])
                        gt_ignore |= (nvis == 0)
                    gt_ignore = gt_ignore | (gt_areas < lo) | (gt_areas >= hi)
                    npos += int((~gt_ignore).sum())

                    if not d:
                        continue
                    if task == "segm":
                        h, w = d[0]["segm"]["size"]
                        det_masks = [rle_decode(e["segm"]) for e in d]
                        gt_masks = [gt_segmentation_mask(
                            a["segmentation"], h, w) for a in gt]
                        ious = _mask_iou_matrix(det_masks, gt_masks)
                        d_areas = np.array(
                            [rle_area(e["segm"]) for e in d], np.float64)
                    else:
                        det_kpts = np.array([e["kpts"] for e in d],
                                            np.float64)
                        raw = [np.asarray(a.get("keypoints", []),
                                          np.float64).reshape(-1, 3)
                               for a in gt]
                        K = max([len(r) for r in raw] + [1])
                        gt_kpts = np.zeros((len(gt), K, 3))
                        for gi, r in enumerate(raw):
                            gt_kpts[gi, :len(r)] = r
                        ious = _oks_matrix(det_kpts, gt_kpts, gt_areas,
                                           COCO_KPT_SIGMAS)
                        d_areas = np.array([
                            max(e["bbox"][2] - e["bbox"][0], 0.0) *
                            max(e["bbox"][3] - e["bbox"][1], 0.0)
                            for e in d], np.float64)
                    tp, ign = _match_from_ious(ious, gt_ignore, IOU_THRS)
                    oob = (d_areas < lo) | (d_areas >= hi)
                    ign = ign | (oob[None, :] & ~tp)
                    tps.append(tp)
                    igns.append(ign)
                    scs.append(scores)
                if tps:
                    ap_list.append(_average_precision(
                        np.concatenate(tps, axis=1),
                        np.concatenate(igns, axis=1), np.concatenate(scs),
                        npos))
                else:
                    ap_list.append(np.full(len(IOU_THRS), np.nan))
            per_area[area_name] = np.stack(ap_list)
        return _summary(per_area)
