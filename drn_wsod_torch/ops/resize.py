"""Linear, antialiased scale of an image with a scale known only on the
device (counterpart of ``jax.image.scale_and_translate(image, shape, (0, 1),
scale, zeros, "linear", antialias=True)`` as
``drn_wsod_tpu/tta.py:_device_view_batch`` calls it).

Each spatial axis gets JAX's weight matrix (``compute_weight_mat`` of
``jax/_src/image/scale.py``): output pixel i samples the input at
``(i + 0.5) / scale - 0.5`` through a triangle kernel widened by
``max(1 / scale, 1)`` (antialiasing when shrinking); each output column's
weights are normalised to sum to one (zero where the sum is below
``1000 * eps``), and zeroed where the sample lies outside
``[-0.5, in - 0.5]``. The image is then two float32 products, rows first.
JAX contracts them at HIGHEST precision, so the products here run in full
float32: TF32 would move pixels by up to about 0.25 on the 0-255 scale.
This is plain torch: the JAX package calls a library function here, not a
Pallas kernel.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def weight_mat(input_size: int, output_size: int,
               scale: torch.Tensor) -> torch.Tensor:
    """(input_size, output_size) float32 resampling weights for a 0-d
    float32 ``scale`` (output pixels per input pixel)."""
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


@contextlib.contextmanager
def _full_float32():
    """Matrix products in full float32 (no TF32) inside the block."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def scale_linear(image: torch.Tensor, out_hw, scale_y: torch.Tensor,
                 scale_x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) float32 image -> (out_h, out_w, C): pixel (y, x) of the
    input lands at (y * scale_y, x * scale_x), half-pixel centres, linear
    kernel with antialiasing; output pixels that sample outside the input
    are 0. ``scale_y`` and ``scale_x`` are 0-d float32 tensors on the
    image's device."""
    H, W, C = image.shape
    out_h, out_w = out_hw
    wy = weight_mat(H, out_h, scale_y)                    # (H, out_h)
    wx = weight_mat(W, out_w, scale_x)                    # (W, out_w)
    with _full_float32():
        rows = torch.matmul(wy.T, image.reshape(H, W * C))  # (out_h, W*C)
        rows = rows.reshape(out_h, W, C).permute(0, 2, 1)   # (out_h, C, W)
        out = torch.matmul(rows, wx)                        # (out_h, C, out_w)
    return out.permute(0, 2, 1).contiguous()
