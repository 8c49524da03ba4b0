"""The differentiable exact RoIPool and RoIAlign (counterparts of
``drn_wsod_tpu/ops/roi_align.py:roi_pool`` and ``roi_align``).

The model pools through this function where the pool must carry gradients
to the map (RoIAlign always: its JAX counterpart is XLA, not a Pallas
kernel, so it has no hand-written kernel here): CSC heads take image gradients through it for their
class-peak-gradient maps, and a trainable backbone (``FREEZE_AT < 5``)
takes feature gradients. The forward-only kernel K1
(:func:`drn_wsod_torch.ops.roi_pool.roi_pool_batched`) serves every other
configuration, as in the JAX package (``models/build.py:111-117``).

Each bin max is the max of four lookups in the sparse range-max tables (the
two power-of-two windows that cover each integer span, on each axis), so
the forward is bit-equal to the JAX function's. The gradient is autograd's
through the same operations: ``torch.maximum`` sends half the gradient each
way on a tie, as ``jnp.maximum``'s VJP does, and a gather's gradient is a
scatter-add, as ``jnp.take``'s is. Plain torch ops on either device.
"""

from __future__ import annotations

import torch

from .roi_pool import _CHUNK, _pool_cells, map_coords


def roi_pool(features: torch.Tensor, boxes: torch.Tensor,
             spatial_scale: float, resolution: int = 7) -> torch.Tensor:
    """Exact, differentiable RoIPool of one image.

    features: (H, W, C); boxes: (P, 4) XYXY image coordinates.
    Returns (P, R, R, C) in ``features.dtype``; RoIs are pooled 512 at a
    time, as the JAX function maps over chunks of 512, which bounds the
    gathered tensors autograd keeps."""
    return _pool_cells(features, *map_coords(boxes, spatial_scale),
                       resolution)


def _bilinear_1d(coord: torch.Tensor, size: int):
    """(lo, hi, w_lo, w_hi) of 1-D bilinear sampling at ``coord`` on a
    ``size``-cell axis, torchvision's boundary rule: points outside
    [-1, size] weigh zero, others are clamped into the map."""
    oob = (coord < -1.0) | (coord > size)
    c = coord.clamp(0.0, size - 1)
    lo = torch.floor(c)
    hi = (lo + 1).clamp(max=size - 1)
    w_hi = c - lo
    w_lo = 1.0 - w_hi
    return (lo.long(), hi.long(), torch.where(oob, 0.0, w_lo),
            torch.where(oob, 0.0, w_hi))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA contracts it: the float64
    product of two float32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              spatial_scale: float, resolution: int = 7,
              sampling_ratio: int = 2, aligned: bool = False) -> torch.Tensor:
    """Bilinear average RoI pooling of one image (RoIAlign; ROIAlignV2 with
    ``aligned``: the -0.5 pixel offset and no minimum RoI size of 1).

    features: (H, W, C); boxes: (P, 4) XYXY image coordinates. Each bin
    averages ``sampling_ratio``^2 bilinear samples (a static ratio, as in
    the JAX package). The accumulation runs in the map's dtype: each
    corner weight (computed in float32) is cast to it before its multiply,
    the four corners are summed, added to the running sum, and the sum is
    divided by the sample count, all rounded to the map's dtype as the JAX
    function rounds them. The sample points are computed as XLA compiles
    the JAX function: the bin size multiplied by float32(1 / R), and each
    point one fused multiply-add. RoIs are pooled 512 at a time. Returns
    (P, R, R, C) in ``features.dtype``; differentiable in ``features``."""
    H, W, C = features.shape
    R, S = resolution, sampling_ratio
    dt = features.dtype
    scaled = boxes.float() * spatial_scale - (0.5 if aligned else 0.0)
    x1, y1, x2, y2 = scaled.unbind(-1)
    roi_w, roi_h = x2 - x1, y2 - y1
    if not aligned:
        roi_w, roi_h = roi_w.clamp(min=1.0), roi_h.clamp(min=1.0)
    # XLA multiplies by float32(1 / R) in place of the division
    inv_r = float(torch.tensor(1.0) / R)
    bin_w, bin_h = roi_w * inv_r, roi_h * inv_r
    flat = features.reshape(H * W, C)
    ph = torch.arange(R, dtype=torch.float32, device=features.device)

    def gather(yi, xi):
        idx = yi[:, :, None] * W + xi[:, None, :]
        return flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (C,))

    def weight(wy, wx):
        return (wy[:, :, None] * wx[:, None, :])[..., None].to(dt)

    outs = []
    for s in range(0, boxes.shape[0], _CHUNK):
        sl = slice(s, s + _CHUNK)
        acc = torch.zeros((x1[sl].shape[0], R, R, C), dtype=dt,
                          device=features.device)
        for iy in range(S):
            ys = _fma(ph[None, :] + (iy + 0.5) / S, bin_h[sl, None],
                      y1[sl, None])
            yl, yh, wyl, wyh = _bilinear_1d(ys, H)
            for ix in range(S):
                xs = _fma(ph[None, :] + (ix + 0.5) / S, bin_w[sl, None],
                          x1[sl, None])
                xl, xh, wxl, wxh = _bilinear_1d(xs, W)
                v = (gather(yl, xl) * weight(wyl, wxl)
                     + gather(yl, xh) * weight(wyl, wxh)
                     + gather(yh, xl) * weight(wyh, wxl)
                     + gather(yh, xh) * weight(wyh, wxh))
                acc = acc + v
        outs.append(acc / torch.tensor(S * S, dtype=dt))
    return torch.cat(outs)
