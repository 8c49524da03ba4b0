"""Deformable convolution, v1 and modulated v2 (counterpart of
``drn_wsod_tpu/ops/deform_conv.py``).

Each output position samples its K x K taps at learned (dy, dx) offsets by
bilinear interpolation, zero outside the map, optionally scales them by a
modulation mask (v2), and contracts them with the kernel. In the JAX package
this is gathers and an einsum outside any Pallas kernel, so here it is torch
ops: index gathers and one ``torch.matmul``. Stride 1, SAME padding.
"""

from __future__ import annotations

from typing import Optional

import torch


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weight: torch.Tensor,
                  modulation: Optional[torch.Tensor] = None,
                  dilation: int = 1) -> torch.Tensor:
    """Deformable conv of a batch.

    Args:
      x: (B, H, W, Cin).
      offsets: (B, H, W, 2*K*K) float32, (dy, dx) per tap, taps in
        row-major order over the kernel.
      weight: (Cout, Cin, K, K) (torch's conv layout).
      modulation: optional (B, H, W, K*K) float32 scales (v2, already
        sigmoid-activated).

    Each corner's bilinear weight is computed in float32 and cast to
    ``x.dtype`` before its multiply, the four corners summed in
    ``x.dtype``, then the modulation (cast to ``x.dtype``) multiplied in, as
    the JAX function rounds them; the contraction over (K*K*Cin)
    accumulates in float32 and is cast back to ``x.dtype``.
    Returns (B, H, W, Cout)."""
    B, H, W, Cin = x.shape
    Cout, _, K, _ = weight.shape
    dev = x.device
    r = dilation * (K - 1) // 2
    taps = torch.arange(K, device=dev) * dilation - r
    base_dy = taps.repeat_interleave(K).float()                  # (K*K,)
    base_dx = taps.repeat(K).float()
    hh = torch.arange(H, dtype=torch.float32, device=dev)[:, None, None]
    ww = torch.arange(W, dtype=torch.float32, device=dev)[None, :, None]
    off = offsets.reshape(B, H, W, K * K, 2)
    ys = hh + base_dy + off[..., 0]                          # (B, H, W, KK)
    xs = ww + base_dx + off[..., 1]
    flat = x.reshape(B * H * W, Cin)
    img = (torch.arange(B, device=dev) * (H * W))[:, None, None, None]

    def corner(yi, xi, wy, wx):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = img + yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat.index_select(0, idx.reshape(-1)).reshape(
            B, H, W, K * K, Cin)
        return v * (wy * wx * inb.float())[..., None].to(v.dtype)

    y0, x0 = torch.floor(ys), torch.floor(xs)
    fy, fx = ys - y0, xs - x0
    y0, x0 = y0.long(), x0.long()
    sampled = (corner(y0, x0, 1 - fy, 1 - fx)
               + corner(y0, x0 + 1, 1 - fy, fx)
               + corner(y0 + 1, x0, fy, 1 - fx)
               + corner(y0 + 1, x0 + 1, fy, fx))       # (B, H, W, KK, Cin)
    if modulation is not None:
        sampled = sampled * modulation[..., None].to(sampled.dtype)
    w = weight.permute(2, 3, 1, 0).reshape(K * K * Cin, Cout)
    out = torch.matmul(sampled.reshape(B, H, W, K * K * Cin).float(),
                       w.float())
    return out.to(x.dtype)
