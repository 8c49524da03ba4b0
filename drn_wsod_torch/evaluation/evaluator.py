"""The detect function and the dataset inference loop (counterpart of
``drn_wsod_tpu/evaluation/evaluator.py``: ``make_detect_fn``,
``inference_on_dataset``, ``gather_and_evaluate``).

The mask and keypoint arms come with ROADMAP.md queue 1, item 14, the dense
evaluation loops with item 15, the gather across processes with item 16.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.nms import multiclass_nms
from ..postprocessing import rescale_boxes
from ..structures.batch import WSODBatch

logger = logging.getLogger(__name__)


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


def inference_on_dataset(detect: Callable[[WSODBatch], Dict[str, torch.Tensor]],
                         loader: Iterable[Tuple[WSODBatch, int]], evaluator,
                         records) -> Dict:
    """Run ``detect`` (the model closed over, as :func:`make_detect_fn`
    returns it) over ``loader``'s (batch, n_real) pairs, feed each real
    image's detections to ``evaluator`` and evaluate.

    ``records`` are the loader's dataset records, indexed by each batch's
    ``image_id``. The time per image is logged: each batch is timed from
    the call to the host copy of its detections (the copy waits for the
    device), the first batch (warm-up) left out.
    """
    evaluator.reset()
    total_images = 0
    total_time = 0.0
    warmup = 1
    n_batches = 0
    for batch, n_real in loader:
        t0 = time.perf_counter()
        dets = detect(batch)
        host = {k: dets[k].cpu().numpy()
                for k in ("boxes", "scores", "classes", "valid")}
        dt = time.perf_counter() - t0
        n_batches += 1
        if n_batches > warmup:
            total_time += dt
            total_images += n_real
        ids = np.asarray(batch.image_id.cpu())
        for i in range(n_real):
            record = records[int(ids[i])]
            evaluator.process_single(
                str(record["image_id"]), host["boxes"][i], host["scores"][i],
                host["classes"][i], host["valid"][i])

    if total_images:
        logger.info(
            f"Inference: {total_time / total_images:.4f} s/img "
            f"({total_images / max(total_time, 1e-9):.2f} img/s)")
    return gather_and_evaluate(evaluator)


def gather_and_evaluate(evaluator) -> Dict:
    """Evaluate the predictions of this process. A process group of more
    than one process would need them gathered first, which is not ported
    yet (ROADMAP.md queue 1, item 16), so it raises."""
    if torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "gathering predictions across processes is not ported yet: "
            "ROADMAP.md queue 1, item 16 (multi-device)")
    return evaluator.evaluate()
