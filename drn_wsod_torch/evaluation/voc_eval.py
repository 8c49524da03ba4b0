"""Pascal VOC detection evaluation: mAP over IoU 0.50:0.95 and CorLoc
(counterpart of ``drn_wsod_tpu/evaluation/voc_eval.py``, its numpy path).

The VOC devkit's arithmetic: +1 pixel areas, greedy per-image GT matching in
descending confidence (a stable sort, so tied detections keep their order),
the 11-point (VOC07) or area AP. CorLoc counts an image of a class as
correct when its highest-scoring detection of the class overlaps a GT box
above the threshold.

The matching runs in the host C++ core ``ops/csrc/eval_core.cpp``
(``native.py``: ``voc_match``, ``voc_corloc``), fed the arrays the JAX
package feeds its native core, built at first use; a failed build raises.
The numpy loops of the JAX package's fallback stay as the core's plain
twin, reached only through ``native=False``: both give the same TP / FP
arrays and verdicts, so the same AP and CorLoc to the bit.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from .. import native as _native

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


def _class_arrays(dets, gt_by_image, class_id):
    """The core's inputs for one class: detections in descending
    confidence (a stable sort) with their image's index in ``gt_by_image``
    (-1 for an image it does not list), and the class's GT boxes grouped
    by image with offsets and difficult flags."""
    images = list(gt_by_image)
    index = {im: i for i, im in enumerate(images)}
    gt_boxes, gt_diff, offsets = [], [], [0]
    for im in images:
        for a in gt_by_image[im]:
            if a["category_id"] == class_id:
                gt_boxes.append(a["bbox"])
                gt_diff.append(bool(a.get("difficult", 0)))
        offsets.append(len(gt_boxes))
    image_ids, det_boxes = _sorted_dets(dets)
    det_img = np.array([index.get(im, -1) for im in image_ids], np.int32)
    return (det_boxes, det_img,
            np.asarray(gt_boxes, np.float64).reshape(-1, 4),
            np.asarray(gt_diff, np.uint8), np.asarray(offsets, np.int64))


def _match_plain(dets, gt_by_image, class_id, ovthresh):
    """The core's ``voc_match`` in numpy: (tp, fp) uint8 (D,), npos."""
    class_recs, npos, _ = _gather_class_gt(gt_by_image, class_id)
    image_ids, BB = _sorted_dets(dets)
    nd = len(image_ids)
    tp = np.zeros(nd, np.uint8)
    fp = np.zeros(nd, np.uint8)
    for d in range(nd):
        R = class_recs.get(image_ids[d])
        if R is None:
            fp[d] = 1
            continue
        ovmax, jmax = -np.inf, -1
        if R.bbox.size > 0:
            overlaps = _voc_overlaps(R.bbox, BB[d])
            ovmax = overlaps.max()
            jmax = int(overlaps.argmax())
        if ovmax > ovthresh:
            if not R.difficult[jmax]:
                if not R.det[jmax]:
                    tp[d] = 1
                    R.det[jmax] = True
                else:
                    fp[d] = 1
        else:
            fp[d] = 1
    return tp, fp, npos


def match_class(dets, gt_by_image, class_id: int, ovthresh: float,
                native: bool = True):
    """VOC's greedy matching of one class's detections (a list of
    (image_id, score, x1, y1, x2, y2), VOC 1-based) in descending
    confidence: (tp, fp) uint8 arrays (D,) and npos, the count of
    non-difficult GT boxes. ``native=False`` runs the numpy twin."""
    if not native:
        return _match_plain(dets, gt_by_image, class_id, ovthresh)
    arrays = _class_arrays(dets, gt_by_image, class_id)
    return (*_native.voc_match(*arrays, ovthresh),
            int((arrays[3] == 0).sum()))


def _ap(tp: np.ndarray, fp: np.ndarray, npos: int,
        use_07_metric: bool) -> float:
    fp = np.cumsum(fp.astype(np.float64))
    tp = np.cumsum(tp.astype(np.float64))
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(rec, prec, use_07_metric)


def _core_ap(arrays, ovthresh: float, use_07_metric: bool) -> float:
    """AP of one class from its :func:`_class_arrays` through the core."""
    tp, fp = _native.voc_match(*arrays, ovthresh)
    return _ap(tp, fp, int((arrays[3] == 0).sum()), use_07_metric)


def voc_eval_class(dets, gt_by_image, class_id: int, ovthresh: float,
                   use_07_metric: bool, native: bool = True) -> float:
    """AP of one class. ``dets``: a list of (image_id, score, x1, y1, x2,
    y2) in VOC 1-based coordinates."""
    if len(dets) == 0:
        return 0.0
    if native:
        return _core_ap(_class_arrays(dets, gt_by_image, class_id),
                        ovthresh, use_07_metric)
    return _ap(*_match_plain(dets, gt_by_image, class_id, ovthresh),
               use_07_metric)


def _corloc_plain(dets, gt_by_image, class_id, ovthresh):
    """The core's ``voc_corloc`` in numpy: verdicts int8 in the order of
    ``gt_by_image``."""
    class_recs, _, _ = _gather_class_gt(gt_by_image, class_id)
    index = {im: i for i, im in enumerate(gt_by_image)}
    verdict = np.full(len(index), -1, np.int8)
    image_ids, BB = _sorted_dets(dets)
    for d in range(len(image_ids)):
        iid = image_ids[d]
        R = class_recs.get(iid)
        if R is None or verdict[index[iid]] != -1:
            continue
        if len(R.difficult) == 0 or all(R.difficult):
            continue
        ovmax = -np.inf
        if R.bbox.size > 0:
            ovmax = _voc_overlaps(R.bbox, BB[d]).max()
        verdict[index[iid]] = 1 if ovmax > ovthresh else 0
    return verdict


def corloc_verdicts(dets, gt_by_image, class_id: int, ovthresh: float,
                    native: bool = True) -> np.ndarray:
    """CorLoc's verdict on each image of ``gt_by_image``, in its order:
    int8, 1 where the image's highest-scoring detection of the class
    overlaps one of its GT boxes above the threshold, 0 where not, -1 where
    the image has no detection or no non-difficult GT box of the class.
    ``native=False`` runs the numpy twin."""
    if not native:
        return _corloc_plain(dets, gt_by_image, class_id, ovthresh)
    return _native.voc_corloc(*_class_arrays(dets, gt_by_image, class_id),
                              ovthresh)


def _core_corloc(arrays, ovthresh: float) -> float:
    """CorLoc of one class from its :func:`_class_arrays` through the
    core, over the images with a non-difficult GT box of the class."""
    _, _, _, gt_diff, offsets = arrays
    image = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    npos_im = len(np.unique(image[gt_diff == 0]))
    if len(arrays[0]) == 0 or npos_im == 0:
        return 0.0
    verdict = _native.voc_corloc(*arrays, ovthresh)
    return float((verdict == 1).sum()) / float(npos_im)


def voc_eval_corloc_class(dets, gt_by_image, class_id: int,
                          ovthresh: float, native: bool = True) -> float:
    """CorLoc of one class: per image, only its highest-scoring detection
    counts, correct if it overlaps any GT box of the class above the
    threshold; over the images with a non-difficult GT box of the class."""
    if native:
        return _core_corloc(_class_arrays(dets, gt_by_image, class_id),
                            ovthresh)
    _, _, npos_im = _gather_class_gt(gt_by_image, class_id)
    if len(dets) == 0 or npos_im == 0:
        return 0.0
    verdict = _corloc_plain(dets, gt_by_image, class_id, ovthresh)
    return float((verdict == 1).sum()) / float(npos_im)


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
            # one class's arrays serve every threshold: the same AP and
            # CorLoc as voc_eval_class / voc_eval_corloc_class, whose
            # array building is most of their host time
            arrays = _class_arrays(dets, self._gt, cls_id) if dets else None
            for thresh in range(50, 100, 5):
                t = thresh / 100.0
                aps[thresh].append(
                    0.0 if arrays is None else
                    _core_ap(arrays, t, self._use_07) * 100.0)
                corlocs[thresh].append(
                    0.0 if arrays is None else
                    _core_corloc(arrays, t) * 100.0)
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
