"""Precomputed-proposal loading (counterpart of
``drn_wsod_tpu/data/proposals.py:load_proposals_into_dataset``).

The pickle format is Detectron2's: ``{"ids": [...], "boxes": [(Ri, 4)],
"objectness_logits": [(Ri,)], "bbox_mode": BoxMode}``, with the legacy keys
``indexes`` and ``scores`` accepted. ``transform_proposals`` comes with the
data loader (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import logging
import pickle
from typing import List

import numpy as np

from ..structures.boxes import BoxMode

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
