"""The benchmark's yardstick: frozen copies of the program's shape rules and
cost arithmetic, and the table of the card's peaks. A later change to the
program moves none of them.

Copied from ``drn_wsod_torch`` at commit 84b8633:

* ``map_coords``, ``bin_edges``, ``bin_cells`` and ``roi_pool_bound`` from
  ``ops/roi_pool.py`` (K1's roofline);
* ``boxes_voc`` from ``tools/pool_sweep.py`` (the proposal mix);
* ``pick_bucket`` from ``data/mapper.py``, ``target_size`` from
  ``data/transforms.py:ResizeShortestEdge`` and ``enumerate_views`` from
  ``tta.py`` (which square bucket an image or a TTA view lands in).

They import nothing of the program.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# NVIDIA's data sheet, H100 SXM, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOP_S = 989e12
PEAK_F32_OPS_S = 67e12
PEAK_BYTES_S = 3.35e12


def map_coords(boxes: torch.Tensor, spatial_scale: float):
    """(..., 4) XYXY image boxes -> (x1, y1, roi_w, roi_h) int64 map cells."""
    scaled = torch.round(boxes.float() * spatial_scale).to(torch.int64)
    x1, y1, x2, y2 = scaled.unbind(-1)
    return (x1, y1, (x2 - x1 + 1).clamp(min=1), (y2 - y1 + 1).clamp(min=1))


def bin_edges(start: torch.Tensor, roi_size: torch.Tensor, size: int,
              resolution: int):
    """Integer bin edges of each RoI along one axis, clamped to the map:
    (lo, hi), each (n, R)."""
    i = torch.arange(resolution, device=start.device, dtype=torch.int64)
    lo = (i[None] * roi_size[:, None]) // resolution + start[:, None]
    hi = ((i[None] + 1) * roi_size[:, None] + resolution - 1) // resolution \
        + start[:, None]
    return lo.clamp(0, size), hi.clamp(0, size)


def bin_cells(boxes: torch.Tensor, spatial_scale: float, H: int, W: int,
              resolution: int = 7) -> torch.Tensor:
    """Map cells each RoI's R x R bins cover, summed over its bins: the cell
    reads an exact pool of the RoI makes per channel. (..., 4) -> (...)."""
    x1, y1, roi_w, roi_h = map_coords(boxes.reshape(-1, 4), spatial_scale)
    ylo, yhi = bin_edges(y1, roi_h, H, resolution)
    xlo, xhi = bin_edges(x1, roi_w, W, resolution)
    cells = ((yhi - ylo).clamp(min=0).sum(-1)
             * (xhi - xlo).clamp(min=0).sum(-1))
    return cells.reshape(boxes.shape[:-1])


def roi_pool_bound(feats, boxes, scale, out, spatial_scale: float,
                   epilogue_ops: int = 1):
    """Least time on an H100 for one batched RoIPool call: bytes moved once
    (map, boxes, scales read; output written) over the HBM rate, against
    this data's max comparisons plus ``epilogue_ops`` multiplies per output
    over the float32 rate. ``feats``, ``scale`` and ``out`` are read for
    their shapes and dtypes only. Returns (ms, "bytes" | "operations")."""
    H, W, C = feats.shape[-3:]
    cells = bin_cells(boxes, spatial_scale, H, W).sum().item()
    ops = cells * C + epilogue_ops * out.numel()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (feats, boxes, scale, out))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def boxes_voc(rs, B, P, S):
    """Selective-search-like boxes in an S x S frame: log-normal sides,
    median 56 px at 704 px. ``rs`` is a numpy RandomState or Generator."""
    w = np.exp(rs.normal(np.log(56.0), 0.9, (B, P))).astype(np.float32)
    h = np.exp(rs.normal(np.log(56.0), 0.9, (B, P))).astype(np.float32)
    w = np.clip(w, 8, S - 1)
    h = np.clip(h, 8, S - 1)
    x1 = rs.uniform(0, 1, (B, P)).astype(np.float32) * (S - 1 - w)
    y1 = rs.uniform(0, 1, (B, P)).astype(np.float32) * (S - 1 - h)
    return np.stack([x1, y1, x1 + w, y1 + h], -1)


def pick_bucket(h: int, w: int, buckets: Sequence[int],
                divisibility: int = 32) -> int:
    """Smallest square bucket covering (h, w); beyond the largest, the
    longer side rounded up to ``divisibility``."""
    m = max(h, w)
    for b in sorted(buckets):
        if b >= m:
            return b
    return int(np.ceil(m / divisibility) * divisibility)


def target_size(h: int, w: int, size: int, max_size: int) -> Tuple[int, int]:
    """(new_h, new_w) with the shorter side ``size`` and the longer at most
    ``max_size``, each rounded by ``int(x + 0.5)``."""
    scale = size / min(h, w)
    if h < w:
        new_h, new_w = size, scale * w
    else:
        new_h, new_w = scale * h, size
    if max(new_h, new_w) > max_size:
        s = max_size / max(new_h, new_w)
        new_h, new_w = new_h * s, new_w * s
    return int(new_h + 0.5), int(new_w + 0.5)


def enumerate_views(image_hw, min_sizes, max_size: int, flip: bool):
    """The (new_h, new_w, flip) view list of one image."""
    H, W = image_hw
    views = []
    for size in min_sizes:
        nh, nw = target_size(H, W, size, max_size)
        for do_flip in ((False, True) if flip else (False,)):
            views.append((nh, nw, do_flip))
    return views


def view_groups(image_hw, min_sizes, max_size: int, flip: bool,
                buckets: Sequence[int]):
    """The image's views grouped by bucket, in order of first appearance:
    {bucket: [(nh, nw, flip), ...]} (one model batch and one K1 launch a
    group)."""
    groups = {}
    for v in enumerate_views(image_hw, min_sizes, max_size, flip):
        groups.setdefault(pick_bucket(v[0], v[1], buckets), []).append(v)
    return groups


def train_buckets(sizes, min_sizes, max_size: int, crop: Tuple[float, float],
                  buckets: Sequence[int], divisibility: int = 32):
    """Every bucket an image of one of ``sizes`` ((h, w) pairs) can land in
    under a relative crop of ``crop`` (the kept share of each side, lowest
    to highest), a short side from ``min_sizes`` and a long side at most
    ``max_size``: the shapes the training traffic can produce."""
    out = set()
    for h, w in set(sizes):
        r0 = max(h, w) / min(h, w)
        r_lo, r_hi = max(1.0, r0 * crop[0]), r0 / crop[0]
        for s in min_sizes:
            lo = int(np.floor(s * r_lo)) - 1
            hi = int(np.ceil(min(s * r_hi, max_size))) + 1
            for long_side in range(max(lo, s), hi + 1):
                out.add(pick_bucket(s, long_side, buckets, divisibility))
    return sorted(out)
