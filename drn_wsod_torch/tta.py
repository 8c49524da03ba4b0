"""Test-time augmentation: multi-scale + flip views, scores averaged, one NMS
(counterpart of ``drn_wsod_tpu/tta.py``).

The precomputed proposal set is the same in every view, so the per-proposal
score and box matrices of all views are mapped back to the original frame
and averaged element-wise before a single NMS. Views are grouped by their
size bucket, and each group runs as one batch through the model: one K1
launch per group.

Like the JAX package, proposals are deduplicated once in the original frame
(the reference re-deduplicates per view), which keeps their slots aligned
across views.

Default path (``TEST.AUG.DEVICE_VIEWS``): the raw image crosses to the
device once, u8 and edge-padded, and each view is resized, padded and
flipped on the device (:func:`_device_view_batch`, with
:func:`drn_wsod_torch.ops.resize.scale_linear` in place of
``jax.image.scale_and_translate``). The host path
(:func:`build_view_batch`) resizes each view with Pillow's bilinear filter,
computed in numpy (``data/transforms.py:resize_bilinear``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .data import transforms as T
from .data.datasets.voc import image_level_labels
from .data.mapper import pick_bucket, read_image
from .device import resolve_device
from .ops.nms import multiclass_nms, nms_mask
from .ops.resize import scale_linear
from .structures import boxes as box_ops
from .structures.batch import WSODBatch
from .structures.boxes import unique_boxes_mask
from .utils import tracing


def enumerate_views(image_hw, min_sizes, max_size: int, flip: bool):
    """The (new_h, new_w, flip) view list for one image."""
    H, W = image_hw
    views = []
    for size in min_sizes:
        nh, nw = T.ResizeShortestEdge.target_size(H, W, size, max_size)
        for do_flip in ((False, True) if flip else (False,)):
            views.append((nh, nw, do_flip))
    return views


def _to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``. To a card the copy goes through pinned
    memory, so it does not wait for the work queued on the stream, as a
    copy from pageable memory does."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def build_view_batch(image: np.ndarray, proposals: np.ndarray,
                     objectness: np.ndarray, labels: np.ndarray,
                     min_sizes, max_size: int, flip: bool,
                     buckets, num_proposals: int,
                     views=None) -> Tuple[WSODBatch, Dict[str, torch.Tensor]]:
    """The (V, ...) batch of augmented views of one image, built on the host
    (Pillow's bilinear resize, in numpy: ``data/transforms.py``), as CPU
    tensors.

    ``image`` is the raw (H, W, 3) image, already in channel order;
    ``proposals`` (N, 4) raw-frame boxes after dedup. ``views`` optionally
    restricts the batch to a subset: all of them share the smallest bucket
    that covers every one.
    Returns (batch, inverse info: 'scale' (V, 2) as (sx, sy), 'flip' (V,),
    'width' (V,)).
    """
    H, W = image.shape[:2]
    if views is None:
        views = enumerate_views((H, W), min_sizes, max_size, flip)

    V = len(views)
    P = num_proposals
    bucket = max(pick_bucket(nh, nw, buckets) for nh, nw, _ in views)

    images = np.zeros((V, bucket, bucket, 3), dtype=np.float32)
    props = np.zeros((V, P, 4), dtype=np.float32)
    mask = np.zeros((V, P), dtype=bool)
    obj = np.zeros((V, P), dtype=np.float32)
    hw = np.zeros((V, 2), dtype=np.int32)
    scale = np.zeros((V, 2), dtype=np.float32)
    flips = np.zeros((V,), dtype=np.float32)
    widths = np.zeros((V,), dtype=np.float32)

    n = min(len(proposals), P)
    for v, (nh, nw, do_flip) in enumerate(views):
        tfm = T.ResizeTransform(H, W, nh, nw)
        img = tfm.apply_image(image)
        b = tfm.apply_box(proposals[:n])
        if do_flip:
            img = img[:, ::-1]
            b = np.stack([nw - b[:, 2], b[:, 1], nw - b[:, 0], b[:, 3]],
                         axis=1)
        images[v, :nh, :nw] = img.astype(np.float32)
        props[v, :n] = b
        mask[v, :n] = True
        obj[v, :n] = objectness[:n]
        hw[v] = (nh, nw)
        scale[v] = (nw / W, nh / H)
        flips[v] = float(do_flip)
        widths[v] = nw

    t = torch.from_numpy
    batch = WSODBatch(
        image=t(images), image_hw=t(hw),
        orig_hw=t(np.tile([[H, W]], (V, 1)).astype(np.int32)),
        proposals=t(props), proposal_mask=t(mask), objectness=t(obj),
        labels=t(np.tile(labels[None], (V, 1))),
        image_id=torch.zeros((V,), dtype=torch.int32))
    inv = {"scale": t(scale), "flip": t(flips), "width": t(widths)}
    return batch, inv


def _invert_boxes(boxes: torch.Tensor, inv) -> torch.Tensor:
    """Map (V, P, 4) view-frame boxes back to the original frame."""
    w = inv["width"][:, None]
    f = inv["flip"][:, None]
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    fx1 = torch.where(f > 0, w - x2, x1)
    fx2 = torch.where(f > 0, w - x1, x2)
    sx = inv["scale"][:, None, 0]
    sy = inv["scale"][:, None, 1]
    return torch.stack([fx1 / sx, y1 / sy, fx2 / sx, y2 / sy], dim=-1)


def _invert_all(scores: torch.Tensor, boxes: torch.Tensor,
                inv) -> torch.Tensor:
    """The view-frame box matrix in the original frame: (V, P, 4), or
    (V, P, C, 4) for class-specific (V, P, C*4) boxes."""
    if boxes.shape[-1] == 4:
        return _invert_boxes(boxes, inv)
    V, P = boxes.shape[:2]
    C = scores.shape[-1] - 1
    b = boxes.reshape(V, P * C, 4)
    return _invert_boxes(b, inv).reshape(V, P, C, 4)


def _finish(avg_scores, avg_boxes, prop_mask, nms_thresh: float,
            score_thresh: float, topk: int) -> Dict[str, torch.Tensor]:
    """One image's NMS over its averaged matrices; the matrices ride
    along as all_scores and all_boxes."""
    C = avg_scores.shape[-1] - 1
    dets = multiclass_nms(avg_boxes[None], avg_scores[None, :, :C],
                          prop_mask[None], iou_threshold=nms_thresh,
                          score_threshold=score_thresh, topk=topk)
    dets = {k: v[0] for k, v in dets.items()}
    dets["all_scores"] = avg_scores
    dets["all_boxes"] = avg_boxes
    return dets


def make_tta_detect_fn(model, score_thresh: float, nms_thresh: float,
                       topk: int, device=None):
    """Move ``model`` to ``device`` (CUDA unless the caller names another
    one) and return ``detect(batch, inv)``: the views' scores and
    original-frame boxes averaged, then one NMS. Detections in the original
    frame, with all_scores (P, C+1) and all_boxes."""
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def detect(batch: WSODBatch, inv) -> Dict[str, torch.Tensor]:
        batch = batch.to(dev)
        inv = {k: v.to(dev) for k, v in inv.items()}
        scores, boxes = model.inference_scores(batch)
        avg_boxes = torch.mean(_invert_all(scores, boxes, inv), dim=0)
        avg_scores = torch.mean(scores, dim=0)
        return _finish(avg_scores, avg_boxes, batch.proposal_mask[0],
                       nms_thresh, score_thresh, topk)

    return detect


def make_tta_union_detect_fn(model, score_thresh: float, nms_thresh: float,
                             topk: int, device=None):
    """Union-style TTA: ``detect(batch, inv)`` keeps a (proposal, class)
    slot if it survives the per-class NMS of at least one view, scores it
    by its best surviving view, and runs one more NMS over that union with
    the views' mean boxes (class-agnostic boxes only)."""
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def detect(batch: WSODBatch, inv) -> Dict[str, torch.Tensor]:
        batch = batch.to(dev)
        inv = {k: v.to(dev) for k, v in inv.items()}
        scores, boxes = model.inference_scores(batch)
        C = scores.shape[-1] - 1
        inv_boxes = _invert_boxes(boxes, inv)                  # (V, P, 4)
        fg = scores[..., :C]
        keeps = []
        for b, s, m in zip(inv_boxes, fg, batch.proposal_mask):
            s_c = s.T                                          # (C, P)
            valid = m & (s_c > score_thresh) & torch.isfinite(s_c)
            keeps.append(nms_mask(b, s_c, valid, nms_thresh,
                                  iou=box_ops.pairwise_iou(b, b)).T)
        keeps = torch.stack(keeps)                             # (V, P, C)
        best = torch.where(keeps, fg, 0.0).amax(dim=0)
        union = torch.where(keeps.any(dim=0), best, 0.0)
        dets = multiclass_nms(inv_boxes.mean(dim=0)[None], union[None],
                              batch.proposal_mask[:1],
                              iou_threshold=nms_thresh,
                              score_threshold=score_thresh, topk=topk)
        return {k: v[0] for k, v in dets.items()}

    return detect


def _sum_inverted(scores, boxes, inv):
    """Map per-view boxes back to the original frame and sum both matrices
    over the views (TTA-AVG's reduction before the final division)."""
    return (torch.sum(scores, dim=0),
            torch.sum(_invert_all(scores, boxes, inv), dim=0))


def make_tta_scorer(model):
    """``score(batch, inv)`` -> the group's summed scores and
    original-frame boxes. ``model``, batch and inverse info share a device."""

    @torch.inference_mode()
    def score(batch: WSODBatch, inv):
        scores, boxes = model.inference_scores(batch)
        return _sum_inverted(scores, boxes, inv)

    return score


def _flip_x(width: torch.Tensor, x: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    """float32 ``width - x * scale`` rounded once, as XLA computes the JAX
    package's ``nw - b`` after ``b = boxes * sx`` under ``jax.jit``: it
    contracts the product and the difference into one fused multiply-add.
    The float64 product of two float32 values is exact; the float64
    difference is exact where it fits 53 bits (a scaled coordinate of 128
    or more), and elsewhere its rounding changes the float32 result only if
    it lands on a float32 tie."""
    return (width.double() - x.double() * scale.double()).to(torch.float32)


def _device_view_batch(raw: torch.Tensor, hw0: Sequence[int],
                       new_hw: Sequence[Sequence[int]],
                       flips: Sequence[bool], bucket: int,
                       boxes: torch.Tensor, mask: torch.Tensor,
                       objectness: torch.Tensor, labels: torch.Tensor):
    """One bucket group's (V, bucket, bucket, 3) view batch, built on the
    device from the raw image: the twin of :func:`build_view_batch`.

    raw: (RB, RB, 3) u8 or float, the original pixels edge-padded (the
      linear kernel's boundary taps then see the replicated edge, as PIL's
      clamp does); hw0: the valid (H0, W0); new_hw: each view's (nh, nw);
      flips: each view's flip; boxes (P, 4) original-frame proposals, mask
      (P,), objectness (P,), labels (C,), all on the raw image's device.

    The scale factors are float32 divisions on the device, ``nh / H0`` and
    ``nw / W0``, the boxes are multiplied by them and flipped as
    ``nw - x * sx`` with one rounding (:func:`_flip_x`), as the JAX
    package's compiled graph computes them: the view proposals equal its
    own bit for bit.
    """
    dev = raw.device
    V = len(flips)

    def f32(v):
        return torch.full((), float(v), dtype=torch.float32, device=dev)

    H0, W0 = f32(hw0[0]), f32(hw0[1])
    rawf = raw.to(torch.float32)
    maskf = mask.to(torch.float32)

    imgs, props, scales, widths = [], [], [], []
    for (nh, nw), do_flip in zip(new_hw, flips):
        nhf, nwf = f32(nh), f32(nw)
        sy, sx = nhf / H0, nwf / W0
        im = scale_linear(rawf, (bucket, bucket), sy, sx)
        im[nh:] = 0.0
        im[:, nw:] = 0.0
        if do_flip:
            # the flip puts the valid columns at [bucket - nw, bucket); the
            # roll brings them back to 0 and the zeroed pad to the right
            im = torch.roll(torch.flip(im, [1]), nw - bucket, 1)
        b = boxes * torch.stack([sx, sy, sx, sy])
        if do_flip:
            b = torch.stack([_flip_x(nwf, boxes[:, 2], sx), b[:, 1],
                             _flip_x(nwf, boxes[:, 0], sx), b[:, 3]], dim=1)
        imgs.append(im)
        props.append(b * maskf[:, None])
        scales.append(torch.stack([sx, sy]))
        widths.append(nwf)

    sizes = np.asarray([[*hw0]] + [list(s) for s in new_hw], np.int32)
    sizes = _to_device(sizes, dev)
    flip_f = _to_device(np.asarray(flips, np.float32), dev)
    batch = WSODBatch(
        image=torch.stack(imgs),
        image_hw=sizes[1:],
        orig_hw=sizes[:1].expand(V, 2),
        proposals=torch.stack(props),
        proposal_mask=mask[None].expand(V, -1),
        objectness=(objectness * maskf)[None].expand(V, -1),
        labels=labels[None].expand(V, -1),
        image_id=torch.zeros((V,), dtype=torch.int32, device=dev),
    )
    inv = {"scale": torch.stack(scales), "flip": flip_f,
           "width": torch.stack(widths)}
    return batch, inv


def make_group_scorer(model, flips: Sequence[bool], bucket: int):
    """``run(raw, hw0, new_hw, boxes, mask, objectness, labels)``: one bucket
    group's views built on the device and scored, returning the summed
    score and original-frame box matrices."""

    @torch.inference_mode()
    def run(raw, hw0, new_hw, boxes, mask, objectness, labels):
        with tracing.span("tta.view_build"):
            batch, inv = _device_view_batch(raw, hw0, new_hw, tuple(flips),
                                            bucket, boxes, mask, objectness,
                                            labels)
        scores, bxs = model.inference_scores(batch)
        return _sum_inverted(scores, bxs, inv)

    return run


def make_tta_finalizer(nms_thresh: float, score_thresh: float, topk: int):
    """``finalize(sum_scores, sum_boxes, n_views, prop_mask)``: divide the
    sums by the view count (on the device), then one NMS."""

    @torch.inference_mode()
    def finalize(sum_scores, sum_boxes, n_views: float, prop_mask):
        n = sum_scores.new_full((), n_views)
        return _finish(sum_scores / n, sum_boxes / n, prop_mask,
                       nms_thresh, score_thresh, topk)

    return finalize


class GeneralizedRCNNWithTTAAVG:
    """Record -> TTA-AVG detections in the original frame.

    ``model`` moves to ``device`` (CUDA unless the caller names another
    one; raises where CUDA is absent). ``__call__(record)`` takes the
    record's image (decoding its file unless the record holds the pixels);
    :meth:`detect_image` takes a decoded one."""

    def __init__(self, cfg, model, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.min_sizes = tuple(cfg.TEST.AUG.MIN_SIZES)
        self.max_size = cfg.TEST.AUG.MAX_SIZE
        self.flip = cfg.TEST.AUG.FLIP
        self.buckets = tuple(cfg.INPUT.BUCKETS)
        self.num_proposals = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
        self.fmt = cfg.INPUT.FORMAT
        self.num_classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
        self.device_views = bool(cfg.TEST.AUG.DEVICE_VIEWS)
        self._score = make_tta_scorer(self.model)
        self._finalize = make_tta_finalizer(
            cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            cfg.TEST.DETECTIONS_PER_IMAGE)

    def __call__(self, record: dict) -> Dict[str, np.ndarray]:
        """A packed record's decoded BGR pixels (``data/record_dataset.py``)
        are used as they are; other records are decoded from their file.
        (The JAX package's TTA always decodes the file, so it cannot
        evaluate a packed dataset.)"""
        if "image" in record:
            image = record["image"]
            if self.fmt == "RGB":
                image = np.ascontiguousarray(image[:, :, ::-1])
            return self.detect_image(image, record)
        return self.detect_image(read_image(record["file_name"], self.fmt),
                                 record)

    def groups(self, image_hw) -> Dict[int, list]:
        """The image's views grouped by bucket, in order of first
        appearance (the order the groups run and their sums add)."""
        groups: Dict[int, list] = {}
        for v in enumerate_views(image_hw, self.min_sizes, self.max_size,
                                 self.flip):
            groups.setdefault(pick_bucket(v[0], v[1], self.buckets),
                              []).append(v)
        return groups

    @torch.inference_mode()
    def detect_image(self, image: np.ndarray,
                     record: dict) -> Dict[str, np.ndarray]:
        """Detections of one decoded (H, W, 3) image, in ``INPUT.FORMAT``
        channel order, with the record's proposals and annotations; numpy
        arrays: boxes (topk, 4), scores, classes, valid, all_scores
        (P, C+1), all_boxes. Traced as the span ``tta.image``, identified
        by the record's ``image_id``."""
        with tracing.span("tta.image", id=record.get("image_id")):
            return self._detect_image(image, record)

    def _detect_image(self, image: np.ndarray,
                      record: dict) -> Dict[str, np.ndarray]:
        dev = self.device
        boxes = np.asarray(record["proposal_boxes"], dtype=np.float32)
        logits = np.asarray(record["proposal_objectness_logits"],
                            dtype=np.float32)
        keep = unique_boxes_mask(boxes)
        boxes, logits = boxes[keep], logits[keep]
        labels = image_level_labels(record, self.num_classes)
        groups = self.groups(image.shape[:2])
        n_views = sum(len(g) for g in groups.values())

        sum_scores = sum_boxes = None
        prop_mask: Optional[torch.Tensor] = None
        if self.device_views:
            # the raw image crosses once, u8, edge-padded to a multiple of
            # 256; each group's views are built on the device
            H0, W0 = image.shape[:2]
            rb = int(np.ceil(max(H0, W0) / 256) * 256)
            raw = np.pad(image, ((0, rb - H0), (0, rb - W0), (0, 0)),
                         mode="edge")
            P = self.num_proposals
            n = min(len(boxes), P)
            pboxes = np.zeros((P, 4), np.float32)
            pboxes[:n] = boxes[:n]
            pmask = np.zeros((P,), bool)
            pmask[:n] = True
            pobj = np.zeros((P,), np.float32)
            pobj[:n] = logits[:n]
            raw_d = _to_device(raw, dev)
            args = tuple(_to_device(a, dev) for a in
                         (pboxes, pmask, pobj, labels))
            prop_mask = args[1]
            for bucket, bucket_views in groups.items():
                with tracing.span("tta.group"):
                    scorer = make_group_scorer(
                        self.model, [f for _, _, f in bucket_views], bucket)
                    s, b = scorer(raw_d, (H0, W0),
                                  [(nh, nw) for nh, nw, _ in bucket_views],
                                  *args)
                    sum_scores = s if sum_scores is None else sum_scores + s
                    sum_boxes = b if sum_boxes is None else sum_boxes + b
        else:
            for bucket_views in groups.values():
                with tracing.span("tta.group"):
                    with tracing.span("tta.view_build"):
                        batch, inv = build_view_batch(
                            image, boxes, logits, labels, self.min_sizes,
                            self.max_size, self.flip, self.buckets,
                            self.num_proposals, views=bucket_views)
                        batch = batch.to(dev)
                        inv = {k: v.to(dev) for k, v in inv.items()}
                    s, b = self._score(batch, inv)
                    prop_mask = batch.proposal_mask[0]
                    sum_scores = s if sum_scores is None else sum_scores + s
                    sum_boxes = b if sum_boxes is None else sum_boxes + b
        with tracing.span("tta.finalize"):
            dets = self._finalize(sum_scores, sum_boxes, float(n_views),
                                  prop_mask)
        with tracing.span("tta.readback"):
            return {k: v.cpu().numpy() for k, v in dets.items()}
