"""LVIS AP under the federated annotation protocol (counterpart of
``drn_wsod_tpu/evaluation/lvis_eval.py``), in float64 numpy.

For a class c only the images where c was verified count: those with an
annotation of c, and those that list c in ``neg_category_ids``. Elsewhere
a detection of c is neither a true nor a false positive. On an image that
lists c in ``not_exhaustive_category_ids``, a detection of c that matches
nothing is ignored, not counted false. AP, AP50 and AP75, and APr, APc
and APf over the classes of each frequency tag where the metadata has
them; at most ``MAX_DETS`` (300) detections an image and class. The
matcher and the 101-point AP are the COCO evaluator's.
"""

from __future__ import annotations

import warnings
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .coco_eval import IOU_THRS, _average_precision, _match_image

MAX_DETS = 300


def nanmean_pct(a) -> float:
    """``np.nanmean(a) * 100`` as a float, NaN without a warning where
    every value is NaN."""
    with warnings.catch_warnings(), np.errstate(invalid="ignore"):
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmean(a) * 100)


class LVISDetectionEvaluator:
    """The detection evaluators' protocol: reset / process_single /
    state_dict / merge_states / evaluate.

    ``img_info_by_image`` maps image_id to {"neg_category_ids": [...],
    "not_exhaustive_category_ids": [...]} (contiguous ids);
    ``frequencies`` holds each class's tag, 'r', 'c' or 'f'."""

    def __init__(self, class_names: Sequence[str],
                 gt_by_image: Dict[str, List[dict]],
                 img_info_by_image: Optional[Dict[str, dict]] = None,
                 frequencies: Optional[Sequence[str]] = None):
        self._class_names = list(class_names)
        self._gt = gt_by_image
        self._info = img_info_by_image or {}
        self._freq = list(frequencies) if frequencies is not None else None
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
        return {c: {img: list(d) for img, d in per.items()}
                for c, per in self._dets.items()}

    def merge_states(self, states):
        for st in states:
            for c, per in st.items():
                for img, d in per.items():
                    self._dets[int(c)][img].extend(d)

    def _eval_images(self, cls_id) -> List[str]:
        """The images where ``cls_id`` was verified: annotated, or listed
        as absent."""
        out = []
        for image_id, annos in self._gt.items():
            pos = any(a["category_id"] == cls_id for a in annos)
            neg = cls_id in self._info.get(image_id, {}).get(
                "neg_category_ids", [])
            if pos or neg:
                out.append(image_id)
        return out

    def evaluate(self) -> Dict[str, float]:
        per_class = []
        for cls_id, _ in enumerate(self._class_names):
            tps, igns, scs = [], [], []
            npos = 0
            for image_id in self._eval_images(cls_id):
                annos = self._gt.get(image_id, [])
                gt = [a for a in annos if a["category_id"] == cls_id]
                gt_boxes = np.array([a["bbox"] for a in gt],
                                    dtype=np.float64).reshape(-1, 4)
                gt_ignore = np.zeros(len(gt), dtype=bool)
                npos += len(gt)
                d = self._dets[cls_id].get(image_id, [])
                if not d and not gt:
                    continue
                d = np.array(d, dtype=np.float64).reshape(-1, 5)
                tp, ign, s = _match_image(d[:, 1:], d[:, 0], gt_boxes,
                                          gt_ignore, IOU_THRS, MAX_DETS)
                if cls_id in self._info.get(image_id, {}).get(
                        "not_exhaustive_category_ids", []):
                    ign = ign | ~tp
                tps.append(tp)
                igns.append(ign)
                scs.append(s)
            if tps:
                per_class.append(_average_precision(
                    np.concatenate(tps, axis=1), np.concatenate(igns, axis=1),
                    np.concatenate(scs), npos))
            else:
                per_class.append(np.full(len(IOU_THRS), np.nan))
        ap = np.stack(per_class)                        # (C, T)

        results = {"AP": nanmean_pct(ap), "AP50": nanmean_pct(ap[:, 0]),
                   "AP75": nanmean_pct(ap[:, 5])}
        if self._freq:
            for tag, key in (("r", "APr"), ("c", "APc"), ("f", "APf")):
                sel = [i for i, f in enumerate(self._freq) if f == tag]
                results[key] = nanmean_pct(ap[sel]) if sel else float("nan")
        return results
