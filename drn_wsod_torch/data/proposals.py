"""Precomputed-proposal loading (counterpart of
``drn_wsod_tpu/data/proposals.py:load_proposals_into_dataset``).

The pickle format is Detectron2's: ``{"ids": [...], "boxes": [(Ri, 4)],
"objectness_logits": [(Ri,)], "bbox_mode": BoxMode}``, with the legacy keys
``indexes`` and ``scores`` accepted. ``transform_proposals`` maps one
record's proposals through its augmentation.
"""

from __future__ import annotations

import logging
import pickle
from typing import List

import numpy as np

from ..structures.boxes import BoxMode, unique_boxes_mask

logger = logging.getLogger(__name__)


def load_proposals_into_dataset(dataset_dicts: List[dict],
                                proposal_file: str) -> List[dict]:
    """Copies of the records, each with its proposals in XYXY mode sorted
    by descending objectness (``proposal_boxes``,
    ``proposal_objectness_logits``). The file is a pickle and is trusted:
    unpickling runs code, so load only files from a known source."""
    logger.info(f"Loading proposals from: {proposal_file}")
    with open(proposal_file, "rb") as f:
        proposals = pickle.load(f, encoding="latin1")

    rename = {"indexes": "ids", "scores": "objectness_logits"}
    for old, new in rename.items():
        if old in proposals:
            proposals[new] = proposals.pop(old)

    bbox_mode = proposals.get("bbox_mode", BoxMode.XYXY_ABS)
    if not isinstance(bbox_mode, BoxMode):
        bbox_mode = BoxMode(int(bbox_mode))
    id_to_index = {str(i): k for k, i in enumerate(proposals["ids"])}

    out = []
    for record in dataset_dicts:
        r = dict(record)
        i = id_to_index[str(record["image_id"])]
        boxes = np.asarray(proposals["boxes"][i], dtype=np.float32)
        logits = np.asarray(proposals["objectness_logits"][i],
                            dtype=np.float32)
        inds = np.argsort(-logits, kind="stable")
        r["proposal_boxes"] = BoxMode.convert(boxes[inds], bbox_mode,
                                              BoxMode.XYXY_ABS)
        r["proposal_objectness_logits"] = logits[inds]
        out.append(r)
    return out


def transform_proposals(record: dict, image_hw, transforms, *,
                        min_box_size: float = 0.0, topk: int = 4000):
    """One image's proposals after its augmentation: boxes transformed,
    clipped to ``image_hw``, duplicates dropped (first occurrence kept),
    boxes not wider and taller than ``min_box_size`` dropped, the first
    ``topk`` kept (the record holds them by descending objectness).

    Returns (boxes (N, 4) float32, logits (N,) float32), N <= topk."""
    boxes = np.asarray(record["proposal_boxes"], dtype=np.float32)
    logits = np.asarray(record["proposal_objectness_logits"],
                        dtype=np.float32)
    if transforms is not None:
        boxes = transforms.apply_box(boxes)
    else:
        boxes = boxes.copy()
    h, w = image_hw
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)

    keep = unique_boxes_mask(boxes)
    boxes, logits = boxes[keep], logits[keep]
    wide = (boxes[:, 2] - boxes[:, 0] > min_box_size) & \
           (boxes[:, 3] - boxes[:, 1] > min_box_size)
    boxes, logits = boxes[wide], logits[wide]
    return boxes[:topk], logits[:topk]
