"""Rotated RoIAlign (counterpart of ``drn_wsod_tpu/ops/roi_align_rotated.py``,
which is XLA in the JAX package: torch ops here).

RoIs are (cx, cy, w, h, angle_deg), the angle counter-clockwise. The
coordinates are always "aligned": centres scaled by ``spatial_scale``,
then shifted by -0.5. Each bin averages a fixed S x S grid of bilinear
samples placed in the RoI's own frame and rotated about its centre:

    y = yy * cos(t) - xx * sin(t) + cy
    x = yy * sin(t) + xx * cos(t) + cx

Sample points outside [-1, size] weigh zero; the average divides by the
full S * S. The sum runs in float32 and is cast to the map's dtype at the
end; RoIs are pooled ``chunk`` at a time. The bin size is multiplied by
float32(1 / R), as XLA compiles the JAX function's ``/ R``. Torch's
``cos`` and ``sin`` are not XLA's, so a sample point may sit an ulp from
the JAX one: the pools agree within a tolerance.
"""

from __future__ import annotations

import math

import torch

from .roi_align import _bilinear_1d


def roi_align_rotated(features: torch.Tensor, boxes: torch.Tensor,
                      spatial_scale: float, resolution: int = 7,
                      sampling_ratio: int = 2,
                      chunk: int = 512) -> torch.Tensor:
    """Bilinear average pooling of one image's (H, W, C) map over (P, 5)
    rotated RoIs in image coordinates -> (P, R, R, C) in the map's
    dtype."""
    H, W, C = features.shape
    P = boxes.shape[0]
    R, S = resolution, sampling_ratio
    b = boxes.float()
    cx = b[:, 0] * spatial_scale - 0.5
    cy = b[:, 1] * spatial_scale - 0.5
    roi_w = (b[:, 2] * spatial_scale).clamp(min=1e-6)
    roi_h = (b[:, 3] * spatial_scale).clamp(min=1e-6)
    theta = b[:, 4] * (math.pi / 180.0)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    inv_r = float(torch.tensor(1.0) / R)
    bin_h, bin_w = roi_h * inv_r, roi_w * inv_r
    flat = features.reshape(H * W, C)
    ph = torch.arange(R, dtype=torch.float32, device=features.device)

    outs = []
    for s in range(0, P, chunk):
        sl = slice(s, s + chunk)
        cxc, cyc, bh, bw = cx[sl], cy[sl], bin_h[sl], bin_w[sl]
        rh, rw, cosc, sinc = roi_h[sl], roi_w[sl], cos_t[sl], sin_t[sl]
        N = cxc.shape[0]
        acc = torch.zeros((N, R * R, C), dtype=torch.float32,
                          device=features.device)
        for iy in range(S):
            yy = (-rh[:, None] / 2.0 + ph[None, :] * bh[:, None]
                  + (iy + 0.5) * bh[:, None] / S)             # (N, R)
            for ix in range(S):
                xx = (-rw[:, None] / 2.0 + ph[None, :] * bw[:, None]
                      + (ix + 0.5) * bw[:, None] / S)
                y = (yy[:, :, None] * cosc[:, None, None]
                     - xx[:, None, :] * sinc[:, None, None]
                     + cyc[:, None, None])                   # (N, Ry, Rx)
                x = (yy[:, :, None] * sinc[:, None, None]
                     + xx[:, None, :] * cosc[:, None, None]
                     + cxc[:, None, None])
                ylo, yhi, wy_lo, wy_hi = _bilinear_1d(y.reshape(N, R * R), H)
                xlo, xhi, wx_lo, wx_hi = _bilinear_1d(x.reshape(N, R * R), W)
                for y_i, wy in ((ylo, wy_lo), (yhi, wy_hi)):
                    for x_i, wx in ((xlo, wx_lo), (xhi, wx_hi)):
                        v = flat.index_select(0, (y_i * W + x_i).reshape(-1))
                        acc = acc + v.reshape(N, R * R, C).float() * \
                            (wy * wx)[:, :, None]
        outs.append((acc / (S * S)).reshape(N, R, R, C))
    if not outs:
        return features.new_zeros((0, R, R, C))
    return torch.cat(outs).to(features.dtype)
