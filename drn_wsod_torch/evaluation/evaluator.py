"""The detect function (counterpart of
``drn_wsod_tpu/evaluation/evaluator.py:make_detect_fn``).

The mask and keypoint arms, ``inference_on_dataset`` and the VOC evaluator
come with later slices of the port.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..device import resolve_device
from ..ops.nms import multiclass_nms
from ..postprocessing import rescale_boxes
from ..structures.batch import WSODBatch


def make_detect_fn(model, score_thresh: float, nms_thresh: float,
                   topk: int, device=None
                   ) -> Callable[[WSODBatch], Dict[str, torch.Tensor]]:
    """Move ``model`` to ``device`` (CUDA unless the caller names another
    one) and return ``detect(batch)``: inference scores -> per-class NMS ->
    top-k -> boxes rescaled to the original image frame.

    ``detect`` returns boxes (B, topk, 4), scores (B, topk), classes
    (B, topk), valid (B, topk), and the full all_scores (B, P, C+1) and
    all_boxes matrices.
    """
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def detect(batch: WSODBatch) -> Dict[str, torch.Tensor]:
        batch = batch.to(dev)
        scores, boxes = model.inference_scores(batch)
        C = scores.shape[-1] - 1
        nms_boxes = (boxes if boxes.shape[-1] == 4
                     else boxes.reshape(*boxes.shape[:-1], C, 4))
        dets = multiclass_nms(nms_boxes, scores[..., :C], batch.proposal_mask,
                              iou_threshold=nms_thresh,
                              score_threshold=score_thresh, topk=topk)
        dets["boxes"] = rescale_boxes(dets["boxes"], batch.image_hw,
                                      batch.orig_hw)
        dets["all_scores"] = scores
        dets["all_boxes"] = boxes
        return dets

    return detect
