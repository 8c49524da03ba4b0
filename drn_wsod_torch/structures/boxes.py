"""Box utilities over ``(..., 4)`` XYXY tensors, and the host-side box mode
and dedup helpers of the data path.

Counterpart of ``drn_wsod_tpu/structures/boxes.py``: the same formulas in the
same order, so float32 results agree with the JAX package to the last bit
wherever both backends round the same way.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch

_DEFAULT_SCALE_CLAMP = math.log(1000.0 / 16)


class BoxMode(enum.IntEnum):
    """The box modes of precomputed proposal files (the subset of
    Detectron2's ``BoxMode`` the JAX package keeps)."""

    XYXY_ABS = 0
    XYWH_ABS = 1

    @staticmethod
    def convert(box, from_mode: "BoxMode", to_mode: "BoxMode"):
        """Convert (..., 4) host boxes between the two modes."""
        if from_mode == to_mode:
            return box
        box = np.asarray(box)
        if from_mode == BoxMode.XYWH_ABS and to_mode == BoxMode.XYXY_ABS:
            x, y, w, h = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
            return np.stack([x, y, x + w, y + h], axis=-1)
        if from_mode == BoxMode.XYXY_ABS and to_mode == BoxMode.XYWH_ABS:
            x1, y1, x2, y2 = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
            return np.stack([x1, y1, x2 - x1, y2 - y1], axis=-1)
        raise NotImplementedError(f"{from_mode} -> {to_mode}")


def unique_boxes_mask(boxes_np: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Host-side dedup mask of (N, 4) boxes, first occurrence kept: boxes
    that round to the same integers (after ``scale``) are duplicates."""
    v = np.array([1, 1e3, 1e6, 1e9])
    hashes = np.round(boxes_np * scale) @ v
    _, index = np.unique(hashes, return_index=True)
    mask = np.zeros(len(boxes_np), dtype=bool)
    mask[np.sort(index)] = True
    return mask


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Box areas; zero for degenerate boxes. boxes: (..., 4)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w.clamp(min=0) * h.clamp(min=0)


def clip(boxes: torch.Tensor, image_size) -> torch.Tensor:
    """Clip boxes to [0, w] x [0, h]. image_size: an (h, w) pair of numbers,
    or a tensor whose last dim is (h, w) and whose leading dims broadcast
    against ``boxes[..., 0]``."""
    if torch.is_tensor(image_size):
        h = image_size[..., 0].to(boxes.dtype)
        w = image_size[..., 1].to(boxes.dtype)
    else:
        h, w = (boxes.new_full((), float(v)) for v in image_size)

    def c(v, hi):
        return torch.minimum(v.clamp(min=0), hi)

    return torch.stack([c(boxes[..., 0], w), c(boxes[..., 1], h),
                        c(boxes[..., 2], w), c(boxes[..., 3], h)], dim=-1)


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU between all pairs: (..., N, 4), (..., M, 4) -> (..., N, M).
    Leading dimensions broadcast (the JAX function is 2-D and vmapped).
    Degenerate boxes give IoU 0."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = area(boxes1)[..., :, None]
    a2 = area(boxes2)[..., None, :]
    union = a1 + a2 - inter
    iou = inter / union.clamp(min=1e-12)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def get_deltas(src_boxes: torch.Tensor, target_boxes: torch.Tensor,
               weights=(10.0, 10.0, 5.0, 5.0)) -> torch.Tensor:
    """Encode target boxes relative to source boxes as (dx, dy, dw, dh);
    the inverse of :func:`apply_deltas`. (..., 4), (..., 4) -> (..., 4)."""
    src_w = src_boxes[..., 2] - src_boxes[..., 0]
    src_h = src_boxes[..., 3] - src_boxes[..., 1]
    src_cx = src_boxes[..., 0] + 0.5 * src_w
    src_cy = src_boxes[..., 1] + 0.5 * src_h

    tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
    tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
    tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
    tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

    wx, wy, ww, wh = weights
    eps = 1e-7
    dx = wx * (tgt_cx - src_cx) / src_w.clamp(min=eps)
    dy = wy * (tgt_cy - src_cy) / src_h.clamp(min=eps)
    dw = ww * torch.log(tgt_w.clamp(min=eps) / src_w.clamp(min=eps))
    dh = wh * torch.log(tgt_h.clamp(min=eps) / src_h.clamp(min=eps))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(10.0, 10.0, 5.0, 5.0),
                 scale_clamp: float = _DEFAULT_SCALE_CLAMP) -> torch.Tensor:
    """Decode deltas w.r.t. boxes.

    deltas: (..., K*4); boxes: (..., 4). Returns the shape of ``deltas``.
    """
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = deltas[..., 0::4] / wx
    dy = deltas[..., 1::4] / wy
    dw = (deltas[..., 2::4] / ww).clamp(max=scale_clamp)
    dh = (deltas[..., 3::4] / wh).clamp(max=scale_clamp)

    pred_cx = dx * widths[..., None] + ctr_x[..., None]
    pred_cy = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                       pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h],
                      dim=-1)                                  # (..., K, 4)
    return out.reshape(deltas.shape)
