"""Plain PyTorch pieces of the reference: exact RoIPool, box geometry, the
matcher, multi-class NMS and the linear image scale. Each is a frozen copy
of the program's plain path at commit 84b8633 (the file named on each), so
that the reference computes the same mathematics without importing the
program; the RoIPool also pools its channels in blocks, so that its tables
fit at the training buckets.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Sequence

import numpy as np
import torch

from ..yardstick import bin_edges, map_coords

_EPS32 = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------- RoIPool
# ``drn_wsod_torch/ops/roi_pool.py``: roi_pool, _pool_cells and helpers

_CHUNK = 512


def _max_span(size: int, resolution: int) -> int:
    return max((size + 2 + resolution - 1) // resolution + 1, 1)


def _num_levels(size: int, resolution: int) -> int:
    k = 0
    while (1 << k) <= _max_span(size, resolution):
        k += 1
    return k


def _doubled(t: torch.Tensor, dim: int, d: int) -> torch.Tensor:
    size = t.shape[dim]
    if d >= size:
        return t
    head = torch.maximum(t.narrow(dim, 0, size - d),
                         t.narrow(dim, d, size - d))
    return torch.cat([head, t.narrow(dim, size - d, d)], dim)


def _max_tables(features: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    by_x = [features]
    for i in range(1, kx):
        by_x.append(_doubled(by_x[-1], 1, 1 << (i - 1)))
    rows = []
    for t in by_x:
        col = [t]
        for i in range(1, ky):
            col.append(_doubled(col[-1], 0, 1 << (i - 1)))
        rows.append(torch.stack(col))
    return torch.stack(rows, 1)


def _rmq(lo: torch.Tensor, hi: torch.Tensor, num_levels: int):
    span = (hi - lo).clamp(min=1)
    level = torch.zeros_like(span)
    for k in range(1, num_levels):
        level += (span >= (1 << k)).to(level.dtype)
    pos2 = (hi - torch.pow(2, level)).clamp(min=0)
    return lo, pos2, level


def _pool_cells(features, x1, y1, roi_w, roi_h, resolution: int):
    H, W, C = features.shape
    R = resolution
    ky, kx = _num_levels(H, R), _num_levels(W, R)
    flat = _max_tables(features, ky, kx).reshape(-1, C)
    outs = []
    for s in range(0, x1.shape[0], _CHUNK):
        sl = slice(s, s + _CHUNK)
        ylo, yhi = bin_edges(y1[sl], roi_h[sl], H, R)
        xlo, xhi = bin_edges(x1[sl], roi_w[sl], W, R)
        ys, y2p, ly = _rmq(ylo, yhi, ky)
        xs, x2p, lx = _rmq(xlo, xhi, kx)
        base = (ly[:, :, None] * kx + lx[:, None, :]) * (H * W)
        acc = None
        for yy in (ys, y2p):
            for xx in (xs, x2p):
                idx = base + yy[:, :, None] * W + xx[:, None, :]
                v = flat.index_select(0, idx.reshape(-1)).reshape(
                    idx.shape + (C,))
                acc = v if acc is None else torch.maximum(acc, v)
        valid = ((yhi > ylo)[:, :, None] & (xhi > xlo)[:, None, :])[..., None]
        outs.append(torch.where(valid, acc, torch.zeros((), dtype=acc.dtype,
                                                        device=acc.device)))
    return torch.cat(outs)


def roi_pool(features: torch.Tensor, boxes: torch.Tensor,
             spatial_scale: float, resolution: int,
             channel_block: int = 256) -> torch.Tensor:
    """Exact RoIPool of one (H, W, C) map: (P, 4) XYXY image boxes ->
    (P, R, R, C) in the map's dtype, ``channel_block`` channels at a time."""
    coords = map_coords(boxes, spatial_scale)
    C = features.shape[-1]
    return torch.cat([_pool_cells(features[..., c:c + channel_block].
                                  contiguous(), *coords, resolution)
                      for c in range(0, C, channel_block)], -1)


# ------------------------------------------------------------ box geometry
# ``drn_wsod_torch/structures/boxes.py``

def unique_boxes_mask(boxes_np: np.ndarray, scale: float = 1.0) -> np.ndarray:
    v = np.array([1, 1e3, 1e6, 1e9])
    hashes = np.round(boxes_np * scale) @ v
    _, index = np.unique(hashes, return_index=True)
    mask = np.zeros(len(boxes_np), dtype=bool)
    mask[np.sort(index)] = True
    return mask


def area(boxes: torch.Tensor) -> torch.Tensor:
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return w.clamp(min=0) * h.clamp(min=0)


def pairwise_intersection(boxes1, boxes2):
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    inter = pairwise_intersection(boxes1, boxes2)
    a1 = area(boxes1)[..., :, None]
    a2 = area(boxes2)[..., None, :]
    union = a1 + a2 - inter
    iou = inter / union.clamp(min=1e-12)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


# ---------------------------------------------------------------- matcher
# ``drn_wsod_torch/ops/matcher.py:match`` (no low-quality matches)

def match(quality, gt_valid, thresholds: Sequence[float],
          labels: Sequence[int]):
    q = torch.where(gt_valid[..., :, None], quality,
                    quality.new_full((), -1.0))
    matched_vals, matched_idx = q.max(dim=-2)
    matched_label = torch.full_like(matched_idx, labels[0])
    for thr, lab in zip(thresholds, labels[1:]):
        matched_label = torch.where(matched_vals >= thr,
                                    matched_label.new_full((), lab),
                                    matched_label)
    any_gt = gt_valid.any(dim=-1, keepdim=True)
    matched_idx = torch.where(any_gt, matched_idx, 0)
    matched_label = torch.where(any_gt, matched_label,
                                matched_label.new_full((), labels[0]))
    return matched_idx, matched_label


# -------------------------------------------------------------------- NMS
# ``drn_wsod_torch/ops/nms.py:multiclass_nms``

def _top(x: torch.Tensor, k: int):
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def multiclass_nms(boxes, scores, valid, iou_threshold: float,
                   score_threshold: float, topk: int,
                   per_class_topk: int = 1024,
                   nms_iters: int = 16) -> Dict[str, torch.Tensor]:
    """(B, P, 4) class-agnostic boxes, (B, P, C) scores, (B, P) validity ->
    boxes (B, topk, 4), scores, classes, valid."""
    B, P, C = scores.shape
    T = min(per_class_topk, P)
    neg = scores.new_full((), -math.inf)
    s = torch.where(valid[..., None] & torch.isfinite(scores)
                    & (scores > score_threshold), scores, neg)
    top_s, top_i = _top(s.transpose(1, 2), T)
    per_class = boxes[:, None].expand(B, C, P, 4)
    boxes_c = torch.gather(per_class, 2, top_i[..., None].expand(B, C, T, 4))
    iou = pairwise_iou(boxes_c, boxes_c)
    cand = torch.isfinite(top_s)
    earlier = torch.ones(T, T, dtype=torch.bool,
                         device=scores.device).tril(-1)
    sup = ((iou > iou_threshold) & earlier & cand[..., None, :]
           & cand[..., :, None]).to(torch.float32)
    keep = cand
    for _ in range(min(nms_iters, T)):
        hit = torch.matmul(sup, keep.to(torch.float32)[..., None])[..., 0]
        keep = cand & (hit < 0.5)
    kept = torch.where(keep, top_s, neg).reshape(B, C * T)
    k = min(topk, C * T)
    out_s, flat = _top(kept, k)
    if k < topk:
        out_s = torch.cat([out_s, neg.expand(B, topk - k)], dim=1)
        flat = torch.cat([flat, flat.new_zeros(B, topk - k)], dim=1)
    out_boxes = torch.gather(boxes_c.reshape(B, C * T, 4), 1,
                             flat[..., None].expand(B, topk, 4))
    out_valid = torch.isfinite(out_s)
    return {"boxes": torch.where(out_valid[..., None], out_boxes, 0.0),
            "scores": torch.where(out_valid, out_s, 0.0),
            "classes": flat // T, "valid": out_valid}


# ------------------------------------------------------------ image scale
# ``drn_wsod_torch/ops/resize.py``: weight_mat, scale_linear

@contextlib.contextmanager
def full_float32():
    """Products and convolutions in full float32 (no TF32) in the block."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def weight_mat(input_size: int, output_size: int,
               scale: torch.Tensor) -> torch.Tensor:
    dev = scale.device
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(output_size, dtype=torch.float32, device=dev)
                 + 0.5) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(
        input_size, dtype=torch.float32, device=dev)[:, None]).abs() \
        / kernel_scale
    weights = torch.clamp(1.0 - x, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * _EPS32,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def scale_linear(image, out_hw, scale_y, scale_x) -> torch.Tensor:
    """(H, W, C) float32 -> (out_h, out_w, C), linear with antialiasing."""
    H, W, C = image.shape
    out_h, out_w = out_hw
    wy = weight_mat(H, out_h, scale_y)
    wx = weight_mat(W, out_w, scale_x)
    with full_float32():
        rows = torch.matmul(wy.T, image.reshape(H, W * C))
        rows = rows.reshape(out_h, W, C).permute(0, 2, 1)
        out = torch.matmul(rows, wx)
    return out.permute(0, 2, 1).contiguous()
