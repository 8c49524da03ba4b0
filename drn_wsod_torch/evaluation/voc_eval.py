"""Pascal VOC detection evaluation: mAP over IoU 0.50:0.95 and CorLoc
(counterpart of ``drn_wsod_tpu/evaluation/voc_eval.py``, its numpy path).

The VOC devkit's arithmetic: +1 pixel areas, greedy per-image GT matching in
descending confidence (a stable sort, so tied detections keep their order),
the 11-point (VOC07) or area AP. CorLoc counts an image of a class as
correct when its highest-scoring detection of the class overlaps a GT box
above the threshold. The JAX package runs the matching in a native C core
when it is built; the port builds no host C++ and runs this numpy path.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """AP from recall and precision: the 11-point VOC07 metric, or the
    area under the precision envelope."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = 0.0 if np.sum(rec >= t) == 0 else float(np.max(prec[rec >= t]))
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _voc_overlaps(gt: np.ndarray, box: np.ndarray) -> np.ndarray:
    """VOC devkit IoU of one box against (G, 4) GT, with +1 pixel areas."""
    ixmin = np.maximum(gt[:, 0], box[0])
    iymin = np.maximum(gt[:, 1], box[1])
    ixmax = np.minimum(gt[:, 2], box[2])
    iymax = np.minimum(gt[:, 3], box[3])
    iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
    ih = np.maximum(iymax - iymin + 1.0, 0.0)
    inters = iw * ih
    uni = ((box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
           + (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0) - inters)
    return inters / uni


class _ClassGT:
    __slots__ = ("bbox", "difficult", "det")

    def __init__(self, bbox, difficult):
        self.bbox = bbox
        self.difficult = difficult
        self.det = [False] * len(bbox)


def _gather_class_gt(gt_by_image: Dict[str, List[dict]], class_id: int):
    """Per image, the class's GT boxes and difficult flags; the count of
    non-difficult GT boxes, and of images with one."""
    class_recs = {}
    npos = 0
    npos_im = 0
    for image_id, annos in gt_by_image.items():
        objs = [a for a in annos if a["category_id"] == class_id]
        bbox = np.array([a["bbox"] for a in objs],
                        dtype=np.float64).reshape(-1, 4)
        difficult = np.array([bool(a.get("difficult", 0)) for a in objs],
                             dtype=bool)
        npos += int((~difficult).sum())
        class_recs[image_id] = _ClassGT(bbox, difficult)
        if len(objs) > 0:
            npos_im += min(1, int((~difficult).sum()))
    return class_recs, npos, npos_im


def _sorted_dets(dets):
    """Image ids and (D, 4) float64 boxes in descending confidence."""
    image_ids = [d[0] for d in dets]
    confidence = np.array([d[1] for d in dets])
    BB = np.array([d[2:] for d in dets], dtype=np.float64).reshape(-1, 4)
    order = np.argsort(-confidence, kind="stable")
    return [image_ids[i] for i in order], BB[order]


def voc_eval_class(dets, gt_by_image, class_id: int, ovthresh: float,
                   use_07_metric: bool) -> float:
    """AP of one class. ``dets``: a list of (image_id, score, x1, y1, x2,
    y2) in VOC 1-based coordinates."""
    class_recs, npos, _ = _gather_class_gt(gt_by_image, class_id)
    if len(dets) == 0:
        return 0.0
    image_ids, BB = _sorted_dets(dets)

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        R = class_recs.get(image_ids[d])
        if R is None:
            fp[d] = 1.0
            continue
        ovmax, jmax = -np.inf, -1
        if R.bbox.size > 0:
            overlaps = _voc_overlaps(R.bbox, BB[d])
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())
        if ovmax > ovthresh:
            if not R.difficult[jmax]:
                if not R.det[jmax]:
                    tp[d] = 1.0
                    R.det[jmax] = True
                else:
                    fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)


def voc_eval_corloc_class(dets, gt_by_image, class_id: int,
                          ovthresh: float) -> float:
    """CorLoc of one class: per image, only its highest-scoring detection
    counts, correct if it overlaps any GT box of the class above the
    threshold; over the images with a non-difficult GT box of the class."""
    class_recs, _, npos_im = _gather_class_gt(gt_by_image, class_id)
    if len(dets) == 0 or npos_im == 0:
        return 0.0
    image_ids, BB = _sorted_dets(dets)

    T, F = set(), set()
    for d in range(len(image_ids)):
        iid = image_ids[d]
        if iid in T or iid in F:
            continue
        R = class_recs.get(iid)
        if R is None or len(R.difficult) == 0 or all(R.difficult):
            continue
        ovmax = -np.inf
        if R.bbox.size > 0:
            ovmax = _voc_overlaps(R.bbox, BB[d]).max()
        if ovmax > ovthresh:
            T.add(iid)
        else:
            F.add(iid)
    return len(T) / float(npos_im)


class PascalVOCDetectionEvaluator:
    """Accumulates per-image detections and computes AP, AP50, AP75 and
    CorLoc (CL, CL50, CL75), in percent."""

    def __init__(self, class_names: Sequence[str],
                 gt_by_image: Dict[str, List[dict]], year: int = 2007):
        self._class_names = list(class_names)
        self._gt = gt_by_image
        self._use_07 = year == 2007
        self.reset()

    def reset(self):
        self._dets = defaultdict(list)  # class_id -> [(img, score, 4x coord)]

    def process_single(self, image_id: str, boxes: np.ndarray,
                       scores: np.ndarray, classes: np.ndarray,
                       valid: np.ndarray | None = None):
        """One image's detections, boxes in 0-based XYXY (kept in VOC's
        1-based convention); slots with ``valid`` False are skipped."""
        n = len(scores)
        for i in range(n):
            if valid is not None and not valid[i]:
                continue
            x1, y1, x2, y2 = [float(v) for v in boxes[i]]
            self._dets[int(classes[i])].append(
                (image_id, float(scores[i]), x1 + 1.0, y1 + 1.0, x2, y2))

    def state_dict(self):
        """The accumulated detections, picklable (for a gather across
        processes)."""
        return {k: list(v) for k, v in self._dets.items()}

    def merge_states(self, states):
        """Fold gathered :meth:`state_dict` results in."""
        for st in states:
            for k, v in st.items():
                self._dets[int(k)].extend(v)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        aps = defaultdict(list)
        corlocs = defaultdict(list)
        for cls_id, _name in enumerate(self._class_names):
            dets = self._dets.get(cls_id, [])
            for thresh in range(50, 100, 5):
                aps[thresh].append(
                    voc_eval_class(dets, self._gt, cls_id, thresh / 100.0,
                                   self._use_07) * 100.0)
                corlocs[thresh].append(
                    voc_eval_corloc_class(dets, self._gt, cls_id,
                                          thresh / 100.0) * 100.0)
        mAP = {t: float(np.mean(v)) for t, v in aps.items()}
        mCL = {t: float(np.mean(v)) for t, v in corlocs.items()}
        logger.info("AP50 per class: " +
                    " ".join(f"{n}={a:.2f}" for n, a in
                             zip(self._class_names, aps[50])))
        return {
            "bbox": {"AP": float(np.mean(list(mAP.values()))),
                     "AP50": mAP[50], "AP75": mAP[75],
                     "AP50_per_class": dict(zip(self._class_names, aps[50]))},
            "bbox CorLoc": {"CL": float(np.mean(list(mCL.values()))),
                            "CL50": mCL[50], "CL75": mCL[75]},
        }
