"""Cityscapes' own metrics (counterpart of
``drn_wsod_tpu/evaluation/cityscapes_eval.py``), computed from arrays in
float64 numpy:

  * ``CityscapesSemSegEvaluator``: pixel IoU over the 19 eval classes.
    The GT arrives as raw ``labelIds`` maps (what the
    ``*_gtFine_labelIds.png`` files hold); the canonical labelId ->
    trainId map is applied here, void and ``ignoreInEval`` labels to the
    ignore bin.
  * ``CityscapesInstanceEvaluator``: instance-mask AP over the 8 "thing"
    classes, IoU 0.5:0.05:0.95 (AP and AP50), no area ranges and no cap
    on detections, crowd ("...group") regions ignored; the COCO
    evaluator's matcher and 101-point AP.

Both keep the evaluators' protocol: reset / process_single / state_dict /
merge_states / evaluate.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

from .coco_eval import (IOU_THRS, _average_precision, _mask_iou_matrix,
                        _match_from_ious, gt_segmentation_mask, rle_decode,
                        rle_encode)
from .lvis_eval import nanmean_pct
from .sem_seg_eval import SemSegEvaluator

# (name, labelId, trainId); trainId 255 is void or ignoreInEval
CITYSCAPES_LABELS = [
    ("unlabeled", 0, 255), ("ego vehicle", 1, 255),
    ("rectification border", 2, 255), ("out of roi", 3, 255),
    ("static", 4, 255), ("dynamic", 5, 255), ("ground", 6, 255),
    ("road", 7, 0), ("sidewalk", 8, 1), ("parking", 9, 255),
    ("rail track", 10, 255), ("building", 11, 2), ("wall", 12, 3),
    ("fence", 13, 4), ("guard rail", 14, 255), ("bridge", 15, 255),
    ("tunnel", 16, 255), ("pole", 17, 5), ("polegroup", 18, 255),
    ("traffic light", 19, 6), ("traffic sign", 20, 7),
    ("vegetation", 21, 8), ("terrain", 22, 9), ("sky", 23, 10),
    ("person", 24, 11), ("rider", 25, 12), ("car", 26, 13),
    ("truck", 27, 14), ("bus", 28, 15), ("caravan", 29, 255),
    ("trailer", 30, 255), ("train", 31, 16), ("motorcycle", 32, 17),
    ("bicycle", 33, 18),
]

CITYSCAPES_SEM_SEG_CLASSES = [
    name for name, _, tid in CITYSCAPES_LABELS if tid != 255]

# labelId -> trainId, every id out of the table to the ignore label
_ID_TO_TRAIN = np.full(256, 255, dtype=np.int32)
for _, _lid, _tid in CITYSCAPES_LABELS:
    _ID_TO_TRAIN[_lid] = _tid


def label_ids_to_train_ids(label_map: np.ndarray) -> np.ndarray:
    """Raw gtFine labelIds map -> trainIds (255 = ignore)."""
    return _ID_TO_TRAIN[np.clip(np.asarray(label_map, np.int64), 0, 255)]


class CityscapesSemSegEvaluator(SemSegEvaluator):
    """Pixel IoU over the 19 eval classes from raw labelIds GT; with
    ``gt_is_train_ids`` the GT maps hold trainIds already."""

    def __init__(self, gt_is_train_ids: bool = False):
        super().__init__(CITYSCAPES_SEM_SEG_CLASSES, ignore_label=255)
        self._gt_is_train_ids = gt_is_train_ids

    def process_single(self, pred: np.ndarray, gt: np.ndarray):
        if not self._gt_is_train_ids:
            gt = label_ids_to_train_ids(gt)
        super().process_single(pred, gt)


class CityscapesInstanceEvaluator:
    """Instance-mask AP in the Cityscapes convention. ``gt_by_image`` maps
    image_id to annotations with ``category_id`` (contiguous over
    ``class_names``), ``segmentation`` (polygons or uncompressed RLE) and
    ``iscrowd`` (group regions, ignored)."""

    def __init__(self, class_names: Sequence[str],
                 gt_by_image: Dict[str, List[dict]]):
        self._class_names = list(class_names)
        self._gt = gt_by_image
        self.reset()

    def reset(self):
        # cls -> image_id -> [{"score", "segm" (RLE)}]
        self._dets = defaultdict(lambda: defaultdict(list))

    def process_single(self, image_id: str, boxes, scores, classes,
                       valid=None, masks=None):
        """``masks``: (D, H, W) binary masks at the GT's size; without
        them the image adds nothing."""
        if masks is None:
            return
        for i in range(len(scores)):
            if valid is not None and not valid[i]:
                continue
            self._dets[int(classes[i])][image_id].append(
                {"score": float(scores[i]), "segm": rle_encode(masks[i])})

    def state_dict(self):
        return {c: {img: list(d) for img, d in per.items()}
                for c, per in self._dets.items()}

    def merge_states(self, states):
        for st in states:
            for c, per in st.items():
                for img, d in per.items():
                    self._dets[int(c)][img].extend(d)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        ap_list = []
        for cls_id, _ in enumerate(self._class_names):
            tps, igns, scs = [], [], []
            npos = 0
            for image_id, annos in self._gt.items():
                gt = [a for a in annos if a["category_id"] == cls_id
                      and a.get("segmentation")]
                d = sorted(self._dets[cls_id].get(image_id, []),
                           key=lambda e: -e["score"])
                if not d and not gt:
                    continue
                gt_ignore = np.array(
                    [bool(a.get("iscrowd", 0)) for a in gt], dtype=bool)
                npos += int((~gt_ignore).sum())
                if not d:
                    continue
                h, w = d[0]["segm"]["size"]
                det_masks = [rle_decode(e["segm"]) for e in d]
                gt_masks = [gt_segmentation_mask(a["segmentation"], h, w)
                            for a in gt]
                ious = _mask_iou_matrix(det_masks, gt_masks)
                tp, ign = _match_from_ious(ious, gt_ignore, IOU_THRS)
                tps.append(tp)
                igns.append(ign)
                scs.append(np.array([e["score"] for e in d]))
            if tps:
                ap_list.append(_average_precision(
                    np.concatenate(tps, axis=1),
                    np.concatenate(igns, axis=1),
                    np.concatenate(scs), npos))
            else:
                ap_list.append(np.full(len(IOU_THRS), np.nan))
        ap = np.stack(ap_list)          # (C, T)
        return {"segm": {"AP": nanmean_pct(ap),
                         "AP50": nanmean_pct(ap[:, 0])}}
