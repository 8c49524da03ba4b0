"""The detect function and the dataset inference loop (counterpart of
``drn_wsod_tpu/evaluation/evaluator.py``: ``make_detect_fn``,
``inference_on_dataset``, ``gather_and_evaluate``).

With masks, the detect function adds each detection's mask probabilities
in its box and the loop pastes them into the original image (host numpy,
``ops/mask_ops.py``); with keypoints, it adds the decoded keypoints in the
original frame. The dense loops (``make_sem_seg_fn``,
``sem_seg_inference_on_dataset``, ``decode_panoptic_png``,
``panoptic_inference_on_dataset``) evaluate semantic segmentation (mIoU)
and the panoptic fusion (PQ), reading the GT label maps and panoptic PNGs
with the port's PNG reader. Over several processes each one runs its
shard of the images and :func:`gather_and_evaluate` gathers the evaluator
states to rank 0, which alone evaluates.
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.mask_ops import paste_masks_in_image
from ..ops.nms import multiclass_nms
from ..ops.resize import resize_linear
from ..parallel import multihost
from ..postprocessing import rescale_boxes
from ..structures.batch import WSODBatch

logger = logging.getLogger(__name__)


def make_detect_fn(model, score_thresh: float, nms_thresh: float,
                   topk: int, device=None, mask_on: bool = False,
                   keypoint_on: bool = False
                   ) -> Callable[[WSODBatch], Dict[str, torch.Tensor]]:
    """Move ``model`` to ``device`` (CUDA unless the caller names another
    one) and return ``detect(batch)``: inference scores -> per-class NMS ->
    top-k -> boxes rescaled to the original image frame.

    ``detect`` returns boxes (B, topk, 4), scores (B, topk), classes
    (B, topk), valid (B, topk), and the full all_scores (B, P, C+1) and
    all_boxes matrices. With ``mask_on``, "mask_probs" (B, topk, 2r, 2r):
    each detection's class mask in its box (``predict_masks`` on the boxes
    in the resized frame); with ``keypoint_on``, "keypoints" (B, topk, K,
    3): (x, y) scaled to the original frame by ``orig / resized`` on each
    axis, and the score. The backbone runs once for all of them.
    """
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def detect(batch: WSODBatch) -> Dict[str, torch.Tensor]:
        batch = model.sanitize(batch.to(dev))
        feats = model.features(batch.image)
        scores, boxes = model.inference_scores(batch, feats)
        C = scores.shape[-1] - 1
        nms_boxes = (boxes if boxes.shape[-1] == 4
                     else boxes.reshape(*boxes.shape[:-1], C, 4))
        # a dense detector (RetinaNet) gives candidates of its own, not
        # the batch's proposal slots: every row is live then
        mask = batch.proposal_mask
        if mask.shape[1] != scores.shape[1]:
            mask = torch.ones(scores.shape[:2], dtype=torch.bool,
                              device=scores.device)
        dets = multiclass_nms(nms_boxes, scores[..., :C], mask,
                              iou_threshold=nms_thresh,
                              score_threshold=score_thresh, topk=topk)
        img_boxes = dets["boxes"]          # in the resized frame
        if mask_on:
            dets["mask_probs"] = model.predict_masks(feats, img_boxes,
                                                     dets["classes"])
        if keypoint_on:
            kps = model.predict_keypoints(feats, img_boxes)
            hw, orig = batch.image_hw.float(), batch.orig_hw.float()
            sx = orig[:, 1] / hw[:, 1].clamp(min=1)
            sy = orig[:, 0] / hw[:, 0].clamp(min=1)
            dets["keypoints"] = torch.stack(
                [kps[..., 0] * sx[:, None, None],
                 kps[..., 1] * sy[:, None, None], kps[..., 2]], -1)
        dets["boxes"] = rescale_boxes(img_boxes, batch.image_hw,
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
    ``image_id``. Where ``detect`` gives "mask_probs" and the evaluator's
    ``process_single`` takes ``masks``, each image's masks are pasted at
    its record's height and width; "keypoints" go to ``keypoints`` where
    it takes them. The time per image is logged: each batch is timed from
    the call to the host copy of its detections (the copy waits for the
    device), the first batch (warm-up) left out.
    """
    accepted = set(inspect.signature(evaluator.process_single).parameters)
    evaluator.reset()
    total_images = 0
    total_time = 0.0
    warmup = 1
    n_batches = 0
    for batch, n_real in loader:
        t0 = time.perf_counter()
        dets = detect(batch)
        keys = ["boxes", "scores", "classes", "valid"]
        keys += [k for k in ("mask_probs", "keypoints") if k in dets]
        host = {k: dets[k].cpu().numpy() for k in keys}
        dt = time.perf_counter() - t0
        n_batches += 1
        if n_batches > warmup:
            total_time += dt
            total_images += n_real
        ids = np.asarray(batch.image_id.cpu())
        for i in range(n_real):
            record = records[int(ids[i])]
            kwargs = {}
            if "mask_probs" in host and "masks" in accepted:
                kwargs["masks"] = paste_masks_in_image(
                    np.asarray(host["mask_probs"][i], np.float32),
                    host["boxes"][i], (record["height"], record["width"]))
            if "keypoints" in host and "keypoints" in accepted:
                kwargs["keypoints"] = host["keypoints"][i]
            evaluator.process_single(
                str(record["image_id"]), host["boxes"][i], host["scores"][i],
                host["classes"][i], host["valid"][i], **kwargs)

    if total_images:
        logger.info(
            f"Inference: {total_time / total_images:.4f} s/img "
            f"({total_images / max(total_time, 1e-9):.2f} img/s)")
    return gather_and_evaluate(evaluator)


def gather_and_evaluate(evaluator) -> Dict:
    """Evaluate the predictions of every process: each rank's
    ``state_dict()`` gathered (a pickled all-gather over the process
    group), folded into rank 0's evaluator after a ``reset``, evaluated
    there; every other rank returns {}. One process evaluates its own."""
    if multihost.get_world_size() > 1:
        states = multihost.all_gather_object(evaluator.state_dict())
        if not multihost.is_main_process():
            return {}
        evaluator.reset()
        evaluator.merge_states(states)
    return evaluator.evaluate()


# --------------------------------------------------------------- dense eval
def make_sem_seg_fn(model, device=None
                    ) -> Callable[[WSODBatch], torch.Tensor]:
    """Move ``model`` to ``device`` (CUDA unless the caller names another
    one) and return ``sem(batch)``: the model's ``semantic_logits``
    upsampled to the canvas by ``jax.image.resize``'s bilinear
    (``ops/resize.py:resize_linear``) and their argmax, (B, H, W) int32 on
    the device (a near tie of two classes may take either)."""
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def sem(batch: WSODBatch) -> torch.Tensor:
        batch = batch.to(dev)
        logits = model.semantic_logits(batch)
        B, _, _, C = logits.shape
        H, W = batch.image.shape[1:3]
        up = resize_linear(logits.float(), (B, H, W, C))
        return up.argmax(-1).to(torch.int32)

    return sem


def _resize_nearest(labels: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """The JAX loop's nearest resize of a predicted map: source index
    ``min(i * in // out, in - 1)`` on each axis."""
    h, w = labels.shape
    if (h, w) == (oh, ow):
        return labels
    yi = np.minimum((np.arange(oh) * h) // max(oh, 1), h - 1)
    xi = np.minimum((np.arange(ow) * w) // max(ow, 1), w - 1)
    return labels[np.ix_(yi, xi)]


def sem_seg_inference_on_dataset(sem: Callable[[WSODBatch], torch.Tensor],
                                 loader: Iterable[Tuple[WSODBatch, int]],
                                 evaluator, records) -> Dict:
    """Each real image's predicted map cut to its valid part, resized to
    the record's height and width by :func:`_resize_nearest`, against the
    GT label map of its ``sem_seg_file_name`` (int32), into
    ``evaluator``."""
    from ..data.mapper import read_label_map

    evaluator.reset()
    for batch, n_real in loader:
        pred = sem(batch).cpu().numpy()
        ids = np.asarray(batch.image_id.cpu())
        hw = np.asarray(batch.image_hw.cpu())
        for i in range(n_real):
            record = records[int(ids[i])]
            h, w = int(hw[i, 0]), int(hw[i, 1])
            p = _resize_nearest(pred[i, :h, :w], int(record["height"]),
                                int(record["width"]))
            gt = np.asarray(read_label_map(record["sem_seg_file_name"]),
                            np.int32)
            evaluator.process_single(p, gt)
    return gather_and_evaluate(evaluator)


def decode_panoptic_png(path: str) -> np.ndarray:
    """A COCO panoptic PNG -> (H, W) int32 segment ids, R + 256 G + 256^2
    B of its RGB (Pillow's ``convert("RGB")``, by the port's reader)."""
    from ..data.png import read_png_rgb

    rgb = read_png_rgb(path).astype(np.int64)
    return (rgb[..., 0] + 256 * rgb[..., 1]
            + 256 * 256 * rgb[..., 2]).astype(np.int32)


def panoptic_inference_on_dataset(
        detect: Callable[[WSODBatch], Dict[str, torch.Tensor]],
        sem: Callable[[WSODBatch], torch.Tensor],
        loader: Iterable[Tuple[WSODBatch, int]], evaluator, records,
        num_thing_classes: int, overlap_threshold: float = 0.5,
        stuff_area_limit: int = 4096, conf_threshold: float = 0.5) -> Dict:
    """The panoptic loop: each real image's detections, their masks pasted
    at the record's size and its semantic map (resized by
    :func:`_resize_nearest`) fused by
    ``panoptic_eval.combine_semantic_and_instance_outputs``, against the
    GT panoptic map of its ``pan_seg_file_name`` and ``segments_info``.
    ``detect`` needs the mask arm. Categories: thing class c is c, stuff
    label l (> 0; 0 is the "thing" class) is ``num_thing_classes + l -
    1``, the space the dataset loader gives the GT."""
    from .panoptic_eval import combine_semantic_and_instance_outputs

    evaluator.reset()
    for batch, n_real in loader:
        dets = detect(batch)
        host = {k: dets[k].cpu().numpy() for k in
                ("boxes", "scores", "classes", "valid", "mask_probs")}
        pred = sem(batch).cpu().numpy()
        ids = np.asarray(batch.image_id.cpu())
        hw = np.asarray(batch.image_hw.cpu())
        for i in range(n_real):
            record = records[int(ids[i])]
            oh, ow = int(record["height"]), int(record["width"])
            h, w = int(hw[i, 0]), int(hw[i, 1])
            valid = np.asarray(host["valid"][i], bool)
            boxes = host["boxes"][i][valid]
            masks = paste_masks_in_image(
                np.asarray(host["mask_probs"][i], np.float32)[valid], boxes,
                (oh, ow))
            pan, infos = combine_semantic_and_instance_outputs(
                masks, host["scores"][i][valid], host["classes"][i][valid],
                _resize_nearest(pred[i, :h, :w], oh, ow),
                overlap_threshold=overlap_threshold,
                stuff_area_limit=stuff_area_limit,
                instances_confidence_threshold=conf_threshold)
            for s in infos:
                if not s.get("isthing", False):
                    s["category_id"] = (num_thing_classes
                                        + s["category_id"] - 1)
            evaluator.process_single(
                pan, infos, decode_panoptic_png(record["pan_seg_file_name"]),
                record.get("segments_info", []))
    return gather_and_evaluate(evaluator)
