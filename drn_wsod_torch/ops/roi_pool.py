"""Exact RoIPool: the plain PyTorch version and the CUDA kernel's wrapper.

Semantics (torchvision RoIPool, as the JAX package computes it in
``drn_wsod_tpu/ops/roi_align.py:roi_pool`` and in its Pallas kernels): map
coordinates are ``round_half_even(box * spatial_scale)``; a RoI spans
``max(x2 - x1 + 1, 1)`` cells; bin ``i`` covers cells
``[floor(i * roi / R) + start, ceil((i + 1) * roi / R) + start)`` clamped to
the map; each bin is the exact max over its cells, and an empty (off-map) bin
is 0. The batched form then multiplies by ``roi_scale`` cast to the map's
dtype, rounding once (``drn_wsod_tpu/ops/roi_pool_pallas.py:_xla_fallback``).

:func:`roi_pool_batched` (K1) runs :func:`roi_pool_plain` on CPU tensors and
the hand-written kernel ``csrc/roi_pool.cu`` on CUDA tensors, both as the
implementations of one ``torch.library`` op, ``drn_wsod::roi_pool_batched``.
:func:`roi_pool_image` (K2, one image, with an int8 mode) runs
:func:`roi_pool_image_plain` on CPU tensors and ``csrc/roi_pool_image.cu`` (K1's
body at B = 1) on CUDA tensors; :func:`roi_pool_looped` launches it once per
image, each into its slice of one output.
:func:`roi_pool_banded` (K3, reached from ``roi_pool_batched(...,
allow_banded=True)``) runs :func:`roi_pool_banded_plain` on CPU tensors and
the two launches of ``csrc/roi_pool_banded.cu`` on CUDA tensors. No wrapper
falls back from its kernel to the plain version: a failed build or launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build

# RoIs gathered per step of the plain version (bounds its index tensors)
_CHUNK = 512
# float32(1 / 127), the factor XLA puts in place of a division by 127
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


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


def bin_cells(boxes: torch.Tensor, spatial_scale: float, H: int, W: int,
              resolution: int = 7) -> torch.Tensor:
    """Map cells each RoI's R x R bins cover, summed over its bins: the
    cell reads an exact pool of the RoI makes per channel. (..., 4) ->
    (...) int64."""
    x1, y1, roi_w, roi_h = map_coords(boxes.reshape(-1, 4), spatial_scale)
    ylo, yhi = bin_edges(y1, roi_h, H, resolution)
    xlo, xhi = bin_edges(x1, roi_w, W, resolution)
    cells = ((yhi - ylo).clamp(min=0).sum(-1)
             * (xhi - xlo).clamp(min=0).sum(-1))
    return cells.reshape(boxes.shape[:-1])


def roi_cells(boxes: torch.Tensor, spatial_scale: float, H: int, W: int
              ) -> torch.Tensor:
    """Map cells of each RoI clamped to the map, each counted once: the
    cell reads per channel of a pool that reads every cell of a RoI once
    (K1's body, ``csrc/roi_pool_bins.cuh:batched_kernel``). The R x R bins
    together cover exactly these cells, so this is at most
    :func:`bin_cells`. (..., 4) -> (...) int64."""
    x1, y1, roi_w, roi_h = map_coords(boxes.reshape(-1, 4), spatial_scale)
    w = (x1 + roi_w).clamp(0, W) - x1.clamp(0, W)
    h = (y1 + roi_h).clamp(0, H) - y1.clamp(0, H)
    return (w.clamp(min=0) * h.clamp(min=0)).reshape(boxes.shape[:-1])


# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 ops/s
# outside the tensor cores
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12


def roi_pool_bound(feats, boxes, scale, out, spatial_scale: float,
                   epilogue_ops: int = 1):
    """Least time on an H100 for one batched RoIPool call: bytes moved once
    (map, boxes, scales read; output written) over the HBM rate, against
    this data's max comparisons (cells of every bin times channels, as
    :func:`bin_cells` counts them) plus ``epilogue_ops`` multiplies per
    output over the float32 rate. Returns (ms, "bytes" | "operations")."""
    H, W, C = feats.shape[-3:]
    cells = bin_cells(boxes, spatial_scale, H, W).sum().item()
    ops = cells * C + epilogue_ops * out.numel()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (feats, boxes, scale, out))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def roi_order(boxes: torch.Tensor) -> torch.Tensor:
    """(B, P, 4) boxes -> (B, P) int32 0..P-1 in each row on the boxes'
    device: K1's blocks taking each image's RoIs in RoI order, the launch
    without :func:`top_row_order`."""
    B, P = boxes.shape[:2]
    return torch.arange(P, dtype=torch.int32,
                        device=boxes.device).expand(B, P).contiguous()


def top_row_order(boxes: torch.Tensor) -> torch.Tensor:
    """(B, P, 4) boxes -> (B, P) int32: each image's RoIs in the order of
    their top edge (y1), the order in which the blocks of K1 (and of K3's
    rest launch) take them, so that the RoIs running together share map
    rows and those rows stay in L2 while they run. On an H100 this halves
    K1's time at the eval buckets whose maps outgrow L2 (PERF.md). Torch
    ops on the boxes' device, no host read; any permutation gives the same
    output."""
    return boxes[..., 1].argsort(dim=1).to(torch.int32)


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
    return _pool_cells(features, *map_coords(boxes, spatial_scale),
                       resolution)


def _pool_cells(features: torch.Tensor, x1: torch.Tensor, y1: torch.Tensor,
                roi_w: torch.Tensor, roi_h: torch.Tensor,
                resolution: int) -> torch.Tensor:
    """:func:`roi_pool` of RoIs given in map cells (:func:`map_coords`)."""
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
def _kernel(library: str = "roi_pool", symbol: str = "drn_roi_pool_forward",
            pointers: int = 5, ints: int = 6):
    """A kernel's C entry point: ``pointers`` pointers, ``ints`` ints, the
    spatial scale, the dtype code and the stream."""
    return _build.bind(library, symbol,
                       *([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]))


def _check_aux(features: torch.Tensor, **tensors) -> None:
    """Boxes, scales: float32, contiguous, on the map's device."""
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != features.device:
            raise TypeError(f"{name} must be float32 on {features.device}, "
                            f"got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_map(features: torch.Tensor, rank: int) -> None:
    if features.dtype not in _DTYPE_CODES:
        raise TypeError(f"the roi_pool kernels take bfloat16 or float32 maps, "
                        f"got {features.dtype}")
    if features.dim() != rank or not features.is_contiguous():
        raise ValueError(f"features must be a contiguous rank-{rank} "
                         f"(..., H, W, C) map, got {tuple(features.shape)}")


def _check_batched(features: torch.Tensor, boxes: torch.Tensor,
                   roi_scale: torch.Tensor) -> None:
    """What the batched kernels (K1, K3) take: a contiguous (B, H, W, C)
    bfloat16 or float32 map, 16-byte aligned, C a whole number of 16-byte
    vectors; (B, P, 4) boxes and (B, P) roi_scale, float32 on its device."""
    _check_map(features, 4)
    B, H, W, C = features.shape
    if boxes.shape[:1] != (B,) or boxes.dim() != 3 or boxes.shape[2] != 4:
        raise ValueError(f"boxes must be ({B}, P, 4), got {tuple(boxes.shape)}")
    P = boxes.shape[1]
    if tuple(roi_scale.shape) != (B, P):
        raise ValueError(f"roi_scale must be ({B}, {P}), got "
                         f"{tuple(roi_scale.shape)}")
    _check_aux(features, boxes=boxes, roi_scale=roi_scale)
    vec = 16 // features.element_size()
    if C % vec or features.data_ptr() % 16:
        raise ValueError(f"the kernel moves 16-byte vectors: C ({C}) must be "
                         f"a multiple of {vec} and the map 16-byte aligned")
    if B == 0 or P == 0 or B > 65535:
        raise ValueError(f"the kernel takes 1 <= B <= 65535 and P >= 1, "
                         f"got B={B}, P={P}")


def roi_pool_batched(features: torch.Tensor, boxes: torch.Tensor,
                     spatial_scale: float, resolution: int,
                     roi_scale: torch.Tensor,
                     allow_banded: bool = False) -> torch.Tensor:
    """Exact batched RoIPool with the per-RoI scale fused into the epilogue.

    features: (B, H, W, C) bfloat16 or float32, contiguous; boxes: (B, P, 4)
    float32; roi_scale: (B, P) float32. Returns (B, P, R, R, C) in the map's
    dtype, through the op ``torch.ops.drn_wsod.roi_pool_batched``
    (:func:`roi_pool_op`): CPU tensors go through :func:`roi_pool_plain`;
    CUDA tensors launch the kernel (replaces
    ``roi_pool_pallas.py:roi_pool_pallas_grid``) and add one to
    ``roi_pool_batched.launches``. Eager calls and programs exported by
    ``torch.export`` take this one route.

    ``allow_banded=True`` takes the banded path, :func:`roi_pool_banded`
    (K3), whatever the map's size: the flag alone decides. The JAX package
    takes it only where its VMEM model shrinks the channel tile fourfold
    (``roi_pool_pallas.py:732``), which has no meaning on the card; the
    output is the same either way. The model never sets the flag.
    """
    if allow_banded:
        return roi_pool_banded(features, boxes, spatial_scale, resolution,
                               roi_scale)
    return roi_pool_op(features, boxes, float(spatial_scale),
                       int(resolution), roi_scale)


@torch.library.custom_op("drn_wsod::roi_pool_batched", mutates_args=(),
                         device_types="cpu")
def roi_pool_op(features: torch.Tensor, boxes: torch.Tensor,
                spatial_scale: float, resolution: int,
                roi_scale: torch.Tensor) -> torch.Tensor:
    """K1 as a ``torch.library`` op. Its CPU implementation is
    :func:`roi_pool_plain`; its CUDA implementation (:func:`_roi_pool_cuda`)
    the checked kernel launch; its fake implementation gives the output's
    shape and dtype, so that ``torch.export`` traces through it and the
    exported program holds the op."""
    return roi_pool_plain(features, boxes, spatial_scale, resolution,
                          roi_scale)


@roi_pool_op.register_kernel("cuda")
def _roi_pool_cuda(features, boxes, spatial_scale, resolution, roi_scale):
    _check_batched(features, boxes, roi_scale)
    return _launch_batched(features, boxes, spatial_scale, resolution,
                           roi_scale, top_row_order(boxes))


@roi_pool_op.register_fake
def _roi_pool_fake(features, boxes, spatial_scale, resolution, roi_scale):
    B, _, _, C = features.shape
    return features.new_empty((B, boxes.shape[1], resolution, resolution, C))


def _launch_batched(features: torch.Tensor, boxes: torch.Tensor,
                    spatial_scale: float, resolution: int,
                    roi_scale: torch.Tensor,
                    order: torch.Tensor) -> torch.Tensor:
    """K1's launch on checked inputs, its blocks taking each image's RoIs
    in ``order`` ((B, P) int32, contiguous, each row a permutation of
    0..P-1, on the map's device); adds one to
    ``roi_pool_batched.launches``. The output is the same for every
    order."""
    B, H, W, C = features.shape
    P = boxes.shape[1]
    out = torch.empty((B, P, resolution, resolution, C),
                      dtype=features.dtype, device=features.device)
    err = _kernel()(
        features.data_ptr(), boxes.data_ptr(), roi_scale.data_ptr(),
        order.data_ptr(), out.data_ptr(), B, H, W, C, P, resolution,
        float(spatial_scale), _DTYPE_CODES[features.dtype],
        _build.stream_of(features))
    if err != 0:
        raise RuntimeError(f"roi_pool kernel launch failed: CUDA error {err}")
    roi_pool_batched.launches += 1
    return out


roi_pool_batched.launches = 0


# ---------------------------------------------------------------------------
# K2: one image per launch, float or int8 mode
# ---------------------------------------------------------------------------

def int8_quantize(features: torch.Tensor):
    """Per-channel symmetric int8 quantization of an (H, W, C) map:
    ``ch_scale = max(absmax_c, 1e-6) / 127`` and ``q = clip(round_half_even(
    f32(features) / ch_scale), -127, 127)``. Returns (q int8, ch_scale (C,)
    float32). Plain torch ops on either device, as the JAX package leaves
    them to XLA outside its kernel.

    XLA compiles the division by the constant 127 into a multiply by its
    float32 reciprocal (which can differ from the quotient in the last
    bit), so the port multiplies too; the division by ``ch_scale`` is a
    true float32 division in both. The absmax is max(max, -min) from one
    ``aminmax`` pass in the map's own dtype (exact), and the division reads
    the map there, so no float32 copy of it is made."""
    lo, hi = torch.aminmax(features.reshape(-1, features.shape[-1]), dim=0)
    ch_scale = torch.maximum(hi, -lo).float().clamp(min=1e-6) * _INV_127
    q = torch.round(features / ch_scale).clamp_(-127, 127).to(torch.int8)
    return q, ch_scale


def _bin_scale(boxes: torch.Tensor, spatial_scale: float, H: int, W: int,
               resolution: int, roi_scale: torch.Tensor) -> torch.Tensor:
    """(P, R, R) float32: ``roi_scale`` on bins that meet the map, 0 on
    empty ones."""
    x1, y1, roi_w, roi_h = map_coords(boxes, spatial_scale)
    ylo, yhi = bin_edges(y1, roi_h, H, resolution)
    xlo, xhi = bin_edges(x1, roi_w, W, resolution)
    valid = (yhi > ylo)[:, :, None] & (xhi > xlo)[:, None, :]
    return roi_scale.float()[:, None, None] * valid.float()


def roi_pool_image_plain(features: torch.Tensor, boxes: torch.Tensor,
                         spatial_scale: float, resolution: int = 7,
                         roi_scale=None, quantize_int8: bool = False
                         ) -> torch.Tensor:
    """The plain version of K2: (H, W, C) + (P, 4) -> (P, R, R, C) in the
    map's dtype, with bin scale ``roi_scale * (bin nonempty)`` (ones where
    ``roi_scale`` is None).

    Float mode: ``max * dtype(bin_scale)``. Int8 mode: the max over the
    :func:`int8_quantize` map, then ``dtype((f32(max) * ch_scale) *
    bin_scale)``."""
    H, W, C = features.shape
    if roi_scale is None:
        roi_scale = torch.ones(boxes.shape[:1], device=features.device)
    scale = _bin_scale(boxes, spatial_scale, H, W, resolution,
                       roi_scale)[..., None]
    if not quantize_int8:
        pooled = roi_pool(features, boxes, spatial_scale, resolution)
        return pooled * scale.to(pooled.dtype)
    q, ch_scale = int8_quantize(features)
    m = roi_pool(q, boxes, spatial_scale, resolution)
    return ((m.float() * ch_scale) * scale).to(features.dtype)


def roi_pool_image(features: torch.Tensor, boxes: torch.Tensor,
                   spatial_scale: float, resolution: int = 7,
                   roi_scale=None, quantize_int8: bool = False
                   ) -> torch.Tensor:
    """Exact single-image RoIPool, the counterpart of
    ``roi_pool_pallas.py:roi_pool_pallas``: (H, W, C) bfloat16 or float32,
    contiguous; boxes (P, 4) and roi_scale (P,) or None, float32. Returns
    (P, R, R, C) in the map's dtype. CPU tensors go through
    :func:`roi_pool_image_plain`; CUDA tensors launch
    ``csrc/roi_pool_image.cu`` and add one to
    ``roi_pool_image.launches["roi_pool_image"]`` (float mode) or
    ``["roi_pool_image_int8"]`` (int8 mode)."""
    if not features.is_cuda:
        return roi_pool_image_plain(features, boxes, spatial_scale,
                                    resolution, roi_scale, quantize_int8)
    out = torch.empty((boxes.shape[0], resolution, resolution,
                       features.shape[-1]),
                      dtype=features.dtype, device=features.device)
    _pool_image_into(out, features, boxes, spatial_scale, resolution,
                     roi_scale, quantize_int8)
    return out


roi_pool_image.launches = {"roi_pool_image": 0, "roi_pool_image_int8": 0}


def _pool_image_into(out: torch.Tensor, features: torch.Tensor,
                     boxes: torch.Tensor, spatial_scale: float,
                     resolution: int, roi_scale, quantize_int8: bool) -> None:
    """:func:`roi_pool_image` of a CUDA (H, W, C) map written into ``out``
    ((P, R, R, C) in the map's dtype, contiguous: a slice of a batched
    output, or a fresh tensor); int8 mode quantizes this map alone."""
    _check_map(features, 3)
    C = features.shape[2]
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"boxes must be (P, 4), got {tuple(boxes.shape)}")
    P = boxes.shape[0]
    if roi_scale is None:
        roi_scale = torch.ones((P,), device=features.device)
    if tuple(roi_scale.shape) != (P,):
        raise ValueError(f"roi_scale must be ({P},), got "
                         f"{tuple(roi_scale.shape)}")
    _check_aux(features, boxes=boxes, roi_scale=roi_scale)
    vec = 16 if quantize_int8 else 16 // features.element_size()
    if C % vec or features.data_ptr() % 16:
        raise ValueError(f"the kernel moves 16-byte vectors: C ({C}) must be "
                         f"a multiple of {vec} and the map 16-byte aligned")
    if P == 0:
        raise ValueError("the kernel takes P >= 1")
    order = top_row_order(boxes[None])[0]
    if quantize_int8:
        q, ch_scale = int8_quantize(features)
        _launch_image(q, boxes, spatial_scale, resolution, roi_scale, order,
                      out, ch_scale)
    else:
        _launch_image(features, boxes, spatial_scale, resolution, roi_scale,
                      order, out)


def _launch_image(features: torch.Tensor, boxes: torch.Tensor,
                  spatial_scale: float, resolution: int,
                  roi_scale: torch.Tensor, order: torch.Tensor,
                  out: torch.Tensor, ch_scale=None) -> None:
    """K2's launch on checked inputs into ``out``, its blocks taking the
    RoIs in ``order`` ((P,) int32, a permutation of 0..P-1; the wrapper
    passes the top-row order, as K1's does). Float mode where ``ch_scale``
    is None (``features`` the map); int8 mode otherwise (``features`` the
    quantized map ``q``, ``ch_scale`` its (C,) scales, ``out``'s dtype the
    output's). Adds one to ``roi_pool_image.launches``."""
    H, W, C = features.shape
    P = boxes.shape[0]
    code = _DTYPE_CODES[out.dtype]
    stream = _build.stream_of(features)
    if ch_scale is None:
        name = "roi_pool_image"
        err = _kernel("roi_pool_image", "drn_roi_pool_image_forward", 5, 5)(
            features.data_ptr(), boxes.data_ptr(), roi_scale.data_ptr(),
            order.data_ptr(), out.data_ptr(), H, W, C, P, resolution,
            float(spatial_scale), code, stream)
    else:
        name = "roi_pool_image_int8"
        err = _kernel("roi_pool_image", "drn_roi_pool_image_int8_forward", 6,
                      5)(features.data_ptr(), ch_scale.data_ptr(),
                         boxes.data_ptr(), roi_scale.data_ptr(),
                         order.data_ptr(), out.data_ptr(), H, W, C, P,
                         resolution, float(spatial_scale), code, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    roi_pool_image.launches[name] += 1


def roi_pool_looped(features: torch.Tensor, boxes: torch.Tensor,
                    spatial_scale: float, resolution: int = 7,
                    roi_scale=None, quantize_int8: bool = False
                    ) -> torch.Tensor:
    """(B, H, W, C) + (B, P, 4) [+ (B, P) roi_scale] -> (B, P, R, R, C):
    one :func:`roi_pool_image` per image (the counterpart of
    ``roi_pool_pallas.py:roi_pool_pallas_batched``), each quantizing its
    own image in int8 mode. On CUDA tensors each image's launch writes
    straight into its slice of one output; CPU tensors stack the plain
    version's images."""
    if not features.is_cuda:
        return torch.stack([
            roi_pool_image(features[b], boxes[b], spatial_scale, resolution,
                           None if roi_scale is None else roi_scale[b],
                           quantize_int8)
            for b in range(features.shape[0])])
    _check_map(features, 4)
    B, H, W, C = features.shape
    if boxes.dim() != 3 or boxes.shape[0] != B:
        raise ValueError(f"boxes must be ({B}, P, 4), got "
                         f"{tuple(boxes.shape)}")
    out = torch.empty((B, boxes.shape[1], resolution, resolution, C),
                      dtype=features.dtype, device=features.device)
    for b in range(B):
        _pool_image_into(out[b], features[b], boxes[b], spatial_scale,
                         resolution, None if roi_scale is None else
                         roi_scale[b], quantize_int8)
    return out


# ---------------------------------------------------------------------------
# K3: banded, short RoIs pooled from a band of rows staged in shared memory
# ---------------------------------------------------------------------------

# bands hold the range-max levels {1, 2, 4} in the JAX package: a short
# RoI's y-bins span at most 2^3 - 1 rows (roi_pool_pallas.py:980, :828-834)
_LV_SMALL = 3
# dynamic shared memory a block may use on an H100 (sm_90)
SMEM_PER_BLOCK = 232448
# most RoIs a block of K3's band launch holds in its RoI table at once, and
# the fewest its channel tile must leave room for
RUN_CHUNK, MIN_CHUNK = 512, 64


class BandPartition(NamedTuple):
    """The RoI partition of the banded pool, all on the boxes' device.

    short, band, band_start: (B, P); order: (B * P,) int32, the flat RoI
    indices ``b * P + p`` with the short ones first, grouped by (image,
    band) in RoI order, then the rest; run_start: (B * NB + 1,) int32, run
    ``g = b * NB + k`` being ``order[run_start[g]:run_start[g + 1]]``."""
    short: torch.Tensor
    band: torch.Tensor
    band_start: torch.Tensor
    order: torch.Tensor
    run_start: torch.Tensor
    num_bands: int
    stride: int


def band_partition(boxes: torch.Tensor, spatial_scale: float, H: int,
                   resolution: int = 7, small_h: int = 24,
                   band_rows: int = 48) -> BandPartition:
    """Which RoIs of (B, P, 4) boxes pool from a band of ``band_rows`` map
    rows, and from which: the rule and geometry of
    ``roi_pool_pallas.py:_pack_banded`` (:816-834). Band k starts at row
    ``clip(k * stride, 0, max(H - band_rows, 0))``, stride = band_rows -
    small_h, and a RoI belongs to band ``clip(y1, 0, H - 1) // stride``. A
    RoI is short when its clamped height is at most ``small_h``, it fits in
    its band, and each of its y-bins spans at most 7 rows (range-max level
    <= 2, on the unclamped y1 and height, as :828-829). JAX then caps the
    short RoIs at P padded slots (:850); the port has no slots and no cap.

    Torch ops on the boxes' device, with no host read: the runs' lengths
    stay on the device, where the band kernel reads them."""
    stride = band_rows - small_h
    if stride < 1 or small_h < 1:
        raise ValueError(f"need 1 <= small_h < band_rows, got small_h="
                         f"{small_h}, band_rows={band_rows}")
    B, P = boxes.shape[:2]
    NB = -(-H // stride)
    x1, y1, roi_w, roi_h = map_coords(boxes, spatial_scale)
    y1c = y1.clamp(0, H - 1)
    y2c = (y1 + roi_h - 1).clamp(0, H - 1)
    band = y1c // stride
    band_start = (band * stride).clamp(0, max(H - band_rows, 0))
    ylo, yhi = bin_edges(y1.reshape(-1), roi_h.reshape(-1), H, resolution)
    spans_ok = ((yhi - ylo) < (1 << _LV_SMALL)).all(-1).reshape(B, P)
    short = ((y2c - y1c + 1 <= small_h) & (y2c < band_start + band_rows)
             & spans_ok)

    images = torch.arange(B, device=boxes.device)[:, None]
    key = torch.where(short, images * NB + band, B * NB).reshape(-1)
    order = torch.argsort(key, stable=True).to(torch.int32)
    counts = torch.zeros(B * NB + 1, dtype=torch.int64,
                         device=boxes.device).index_add_(
        0, key, torch.ones_like(key))
    run_start = torch.cat([counts.new_zeros(1),
                           counts[:-1].cumsum(0)]).to(torch.int32)
    return BandPartition(short, band, band_start, order, run_start, NB,
                         stride)


def roi_pool_banded_plain(features: torch.Tensor, boxes: torch.Tensor,
                          spatial_scale: float, resolution: int,
                          roi_scale: torch.Tensor, small_h: int = 24,
                          band_rows: int = 48) -> torch.Tensor:
    """The plain version of K3: each short RoI (:func:`band_partition`)
    pooled from its band ``features[b, bs:bs + rows]`` (rows = min(band_rows,
    H)) with its y-coordinates shifted into the band and clamped to it,
    every other RoI from the full map, then K1's epilogue. Equal to
    :func:`roi_pool_plain` (the shift and the clamps are where a banded
    kernel goes wrong)."""
    B, H, W, C = features.shape
    R = resolution
    part = band_partition(boxes, spatial_scale, H, R, small_h, band_rows)
    rows = min(band_rows, H)
    x1, y1, roi_w, roi_h = map_coords(boxes, spatial_scale)
    out = torch.empty((B, boxes.shape[1], R, R, C), dtype=features.dtype,
                      device=features.device)
    for b in range(B):
        groups = [(~part.short[b], 0, features[b])]
        for k in range(part.num_bands):
            bs = min(k * part.stride, max(H - band_rows, 0))
            groups.append((part.short[b] & (part.band[b] == k), bs,
                           features[b, bs:bs + rows]))
        for mask, bs, rows_map in groups:
            idx = mask.nonzero()[:, 0]
            if idx.numel():
                out[b, idx] = _pool_cells(rows_map, x1[b, idx],
                                          y1[b, idx] - bs, roi_w[b, idx],
                                          roi_h[b, idx], R)
    return out * roi_scale.to(out.dtype)[:, :, None, None, None]


class BandTile(NamedTuple):
    """How K3's band launch cuts its work: ``ct`` channels per block, and
    at most ``chunk`` RoIs in the block's RoI table at once."""
    ct: int
    chunk: int


def band_pitch(W: int, nv: int) -> int:
    """16-byte vectors per staged band row of ``nv`` vectors a cell: W * nv
    padded to nv modulo 8, so that rows read side by side start on
    different shared-memory banks (``csrc/roi_pool_banded.cu:band_pitch``)."""
    return W * nv + (nv - W * nv) % 8


def table_bytes(resolution: int, rois: int) -> int:
    """Shared memory of the band launch's RoI table for ``rois`` RoIs: 2R
    int16 (lo, hi) bin pairs, the output index and the scale of each, and
    a 16-byte counter (``csrc/roi_pool_banded.cu:table_bytes``)."""
    return rois * (8 * resolution + 8) + 16


def band_tile(features: torch.Tensor, band_rows: int = 48,
              resolution: int = 7) -> BandTile:
    """K3's channel tile and RoI chunk: the most channels (a power of two
    times the 16-byte vector, dividing C) whose band, min(band_rows, H)
    rows of :func:`band_pitch` vectors, fits :data:`SMEM_PER_BLOCK` beside
    a table of :data:`MIN_CHUNK` RoIs; the chunk is then the most RoIs, up
    to :data:`RUN_CHUNK`, whose table fits beside that band. Raises where
    not even one vector of band plus a one-RoI table fits."""
    B, H, W, C = features.shape
    vec = 16 // features.element_size()
    rows = min(band_rows, H)

    def band_bytes(ct):
        return rows * band_pitch(W, ct // vec) * 16

    need = band_bytes(vec) + table_bytes(resolution, 1)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"a band of {rows} x {W} cells x {vec} channels and a one-RoI "
            f"table take {need} bytes, more than the {SMEM_PER_BLOCK} of "
            f"shared memory a block may use")
    ct = vec
    while (C % (2 * ct) == 0 and band_bytes(2 * ct)
           + table_bytes(resolution, MIN_CHUNK) <= SMEM_PER_BLOCK):
        ct *= 2
    left = SMEM_PER_BLOCK - band_bytes(ct) - table_bytes(resolution, 0)
    return BandTile(ct, min(RUN_CHUNK, left // (8 * resolution + 8)))


def roi_pool_banded(features: torch.Tensor, boxes: torch.Tensor,
                    spatial_scale: float, resolution: int = 7,
                    roi_scale=None, small_h: int = 24,
                    band_rows: int = 48) -> torch.Tensor:
    """Exact batched RoIPool in two launches, the counterpart of
    ``roi_pool_pallas.py:roi_pool_pallas_banded``: the arguments and result
    of :func:`roi_pool_batched` (roi_scale None: ones). CPU tensors go
    through :func:`roi_pool_banded_plain`. CUDA tensors launch
    ``csrc/roi_pool_banded.cu`` twice, the short RoIs from bands staged in
    shared memory (:func:`_launch_band`) and the rest from the full map as
    K1 launches them, its body in the top-row order (:func:`_launch_rest`).
    No host read: the partition stays on the card."""
    if roi_scale is None:
        roi_scale = torch.ones(boxes.shape[:2], device=features.device)
    if not features.is_cuda:
        return roi_pool_banded_plain(features, boxes, spatial_scale,
                                     resolution, roi_scale, small_h,
                                     band_rows)
    _check_batched(features, boxes, roi_scale)
    tile = band_tile(features, band_rows, resolution)
    part = band_partition(boxes, spatial_scale, features.shape[1], resolution,
                          small_h, band_rows)
    out = torch.empty((*boxes.shape[:2], resolution, resolution,
                       features.shape[3]),
                      dtype=features.dtype, device=features.device)
    _launch_band(features, boxes, spatial_scale, resolution, roi_scale, part,
                 tile, band_rows, out)
    _launch_rest(features, boxes, spatial_scale, resolution, roi_scale,
                 top_row_order(boxes), part.short, out)
    return out


def _launch_band(features: torch.Tensor, boxes: torch.Tensor,
                 spatial_scale: float, resolution: int,
                 roi_scale: torch.Tensor, part: BandPartition,
                 tile: BandTile, band_rows: int, out: torch.Tensor) -> None:
    """K3's band launch on checked inputs: the short RoIs of ``part`` pooled
    into ``out`` from bands staged in shared memory, cut as ``tile`` says;
    adds one to ``roi_pool_banded.launches["roi_pool_banded"]``."""
    B, H, W, C = features.shape
    err = _kernel("roi_pool_banded", "drn_roi_pool_banded_forward", 6, 11)(
        features.data_ptr(), boxes.data_ptr(), roi_scale.data_ptr(),
        part.order.data_ptr(), part.run_start.data_ptr(), out.data_ptr(),
        B, H, W, C, boxes.shape[1], resolution, part.num_bands, part.stride,
        band_rows, tile.ct, tile.chunk, float(spatial_scale),
        _DTYPE_CODES[features.dtype], _build.stream_of(features))
    if err != 0:
        raise RuntimeError(f"roi_pool_banded kernel launch failed: CUDA "
                           f"error {err}")
    roi_pool_banded.launches["roi_pool_banded"] += 1


def _launch_rest(features: torch.Tensor, boxes: torch.Tensor,
                 spatial_scale: float, resolution: int,
                 roi_scale: torch.Tensor, order: torch.Tensor,
                 short: torch.Tensor, out: torch.Tensor) -> None:
    """K3's rest launch on checked inputs: every RoI whose ``short`` entry
    ((B, P) bool, contiguous: one 0/1 byte each) is False, pooled into
    ``out`` by K1's body, its blocks taking the RoIs in ``order`` (as
    :func:`_launch_batched`); adds one to
    ``roi_pool_banded.launches["roi_pool_banded_rest"]``."""
    B, H, W, C = features.shape
    err = _kernel("roi_pool_banded", "drn_roi_pool_banded_rest_forward", 6,
                  6)(features.data_ptr(), boxes.data_ptr(),
                     roi_scale.data_ptr(), order.data_ptr(),
                     short.data_ptr(), out.data_ptr(), B, H, W, C,
                     boxes.shape[1], resolution, float(spatial_scale),
                     _DTYPE_CODES[features.dtype], _build.stream_of(features))
    if err != 0:
        raise RuntimeError(f"roi_pool_banded_rest kernel launch failed: CUDA "
                           f"error {err}")
    roi_pool_banded.launches["roi_pool_banded_rest"] += 1


roi_pool_banded.launches = {"roi_pool_banded": 0, "roi_pool_banded_rest": 0}
