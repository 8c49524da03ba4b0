"""Exact RoIPool: the plain PyTorch version and the CUDA kernel's wrapper.

Semantics (torchvision RoIPool, as the JAX package computes it in
``drn_wsod_tpu/ops/roi_align.py:roi_pool`` and in its Pallas kernels): map
coordinates are ``round_half_even(box * spatial_scale)``; a RoI spans
``max(x2 - x1 + 1, 1)`` cells; bin ``i`` covers cells
``[floor(i * roi / R) + start, ceil((i + 1) * roi / R) + start)`` clamped to
the map; each bin is the exact max over its cells, and an empty (off-map) bin
is 0. The batched form then multiplies by ``roi_scale`` cast to the map's
dtype, rounding once (``drn_wsod_tpu/ops/roi_pool_pallas.py:_xla_fallback``).

:func:`roi_pool_batched` runs :func:`roi_pool_plain` on CPU tensors and the
hand-written kernel ``csrc/roi_pool.cu`` on CUDA tensors. It never falls back
from the kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

# RoIs gathered per step of the plain version (bounds its index tensors)
_CHUNK = 512


def _max_span(size: int, resolution: int) -> int:
    """Largest bin span (cells) on a ``size``-cell axis."""
    return max((size + 2 + resolution - 1) // resolution + 1, 1)


def _num_levels(size: int, resolution: int) -> int:
    """Power-of-two window levels {1, 2, 4, ...} covering every bin span."""
    k = 0
    while (1 << k) <= _max_span(size, resolution):
        k += 1
    return k


def _doubled(t: torch.Tensor, dim: int, d: int) -> torch.Tensor:
    """t[i] <- max(t[i], t[i + d]) along ``dim``; the last ``d`` entries keep
    their (partial, never read) values."""
    size = t.shape[dim]
    if d >= size:
        return t
    head = torch.maximum(t.narrow(dim, 0, size - d), t.narrow(dim, d, size - d))
    return torch.cat([head, t.narrow(dim, size - d, d)], dim)


def _max_tables(features: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    """Sparse range-max tables: T[iy, ix][y, x] = max of
    features[y : y + 2^iy, x : x + 2^ix]. (H, W, C) -> (ky, kx, H, W, C)."""
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


def bin_edges(start: torch.Tensor, roi_size: torch.Tensor, size: int,
              resolution: int):
    """Integer bin edges of each RoI along one axis, clamped to the map.

    start, roi_size: (n,) int64. Returns (lo, hi), each (n, R); a bin is
    empty where ``hi <= lo``."""
    i = torch.arange(resolution, device=start.device, dtype=torch.int64)
    lo = (i[None] * roi_size[:, None]) // resolution + start[:, None]
    hi = ((i[None] + 1) * roi_size[:, None] + resolution - 1) // resolution \
        + start[:, None]
    return lo.clamp(0, size), hi.clamp(0, size)


def map_coords(boxes: torch.Tensor, spatial_scale: float):
    """(..., 4) XYXY image boxes -> (x1, y1, roi_w, roi_h) int64 map cells."""
    scaled = torch.round(boxes.float() * spatial_scale).to(torch.int64)
    x1, y1, x2, y2 = scaled.unbind(-1)
    return (x1, y1, (x2 - x1 + 1).clamp(min=1), (y2 - y1 + 1).clamp(min=1))


def _rmq(lo: torch.Tensor, hi: torch.Tensor, num_levels: int):
    """The two power-of-two windows [lo, lo + 2^k) and [hi - 2^k, hi) that
    cover [lo, hi), k = floor(log2(span)): returns (lo, pos2, k)."""
    span = (hi - lo).clamp(min=1)
    level = torch.zeros_like(span)
    for k in range(1, num_levels):
        level += (span >= (1 << k)).to(level.dtype)
    pos2 = (hi - torch.pow(2, level)).clamp(min=0)
    return lo, pos2, level


def roi_pool(features: torch.Tensor, boxes: torch.Tensor,
             spatial_scale: float, resolution: int = 7) -> torch.Tensor:
    """Exact RoIPool of one image, plain PyTorch.

    features: (H, W, C); boxes: (P, 4) XYXY image coordinates.
    Returns (P, R, R, C) in ``features.dtype``. Each bin max is the max of
    four lookups in the sparse range-max tables (the formulation of
    ``drn_wsod_tpu/ops/roi_align.py:roi_pool``)."""
    H, W, C = features.shape
    R = resolution
    ky, kx = _num_levels(H, R), _num_levels(W, R)
    flat = _max_tables(features, ky, kx).reshape(-1, C)
    x1, y1, roi_w, roi_h = map_coords(boxes, spatial_scale)

    outs = []
    for s in range(0, boxes.shape[0], _CHUNK):
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


def roi_pool_plain(features: torch.Tensor, boxes: torch.Tensor,
                   spatial_scale: float, resolution: int,
                   roi_scale: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel: (B, H, W, C) + (B, P, 4) + (B, P)
    -> (B, P, R, R, C), each RoI multiplied by ``roi_scale`` cast to the
    map's dtype (one rounding, as ``_xla_fallback`` does)."""
    pooled = torch.stack([roi_pool(f, b, spatial_scale, resolution)
                          for f, b in zip(features, boxes)])
    return pooled * roi_scale.to(pooled.dtype)[:, :, None, None, None]


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = _build.load("roi_pool").drn_roi_pool_forward
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def roi_pool_batched(features: torch.Tensor, boxes: torch.Tensor,
                     spatial_scale: float, resolution: int,
                     roi_scale: torch.Tensor) -> torch.Tensor:
    """Exact batched RoIPool with the per-RoI scale fused into the epilogue.

    features: (B, H, W, C) bfloat16 or float32, contiguous; boxes: (B, P, 4)
    float32; roi_scale: (B, P) float32. Returns (B, P, R, R, C) in the map's
    dtype. CPU tensors go through :func:`roi_pool_plain`; CUDA tensors
    launch the kernel (replaces ``roi_pool_pallas.py:roi_pool_pallas_grid``)
    and add one to ``roi_pool_batched.launches``.
    """
    if not features.is_cuda:
        return roi_pool_plain(features, boxes, spatial_scale, resolution,
                              roi_scale)
    if features.dtype not in _DTYPE_CODES:
        raise TypeError(f"roi_pool kernel takes bfloat16 or float32 maps, "
                        f"got {features.dtype}")
    if features.dim() != 4:
        raise ValueError(f"features must be (B, H, W, C), got "
                         f"{tuple(features.shape)}")
    B, H, W, C = features.shape
    if boxes.shape[:1] != (B,) or boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"boxes must be ({B}, P, 4), got {tuple(boxes.shape)}")
    P = boxes.shape[1]
    if tuple(roi_scale.shape) != (B, P):
        raise ValueError(f"roi_scale must be ({B}, {P}), got "
                         f"{tuple(roi_scale.shape)}")
    for name, t in (("boxes", boxes), ("roi_scale", roi_scale)):
        if t.dtype != torch.float32 or t.device != features.device:
            raise TypeError(f"{name} must be float32 on {features.device}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not features.is_contiguous():
        raise ValueError("features must be contiguous (B, H, W, C)")
    vec = 16 // features.element_size()
    if C % vec or features.data_ptr() % 16:
        raise ValueError(f"the kernel moves 16-byte vectors: C ({C}) must be "
                         f"a multiple of {vec} and the map 16-byte aligned")
    if B == 0 or P == 0 or B > 65535:
        raise ValueError(f"the kernel takes 1 <= B <= 65535 and P >= 1, "
                         f"got B={B}, P={P}")

    out = torch.empty((B, P, resolution, resolution, C),
                      dtype=features.dtype, device=features.device)
    err = _kernel()(
        features.data_ptr(), boxes.data_ptr(), roi_scale.data_ptr(),
        out.data_ptr(), B, H, W, C, P, resolution, float(spatial_scale),
        _DTYPE_CODES[features.dtype],
        torch.cuda.current_stream(features.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_pool kernel launch failed: CUDA error {err}")
    roi_pool_batched.launches += 1
    return out


roi_pool_batched.launches = 0
