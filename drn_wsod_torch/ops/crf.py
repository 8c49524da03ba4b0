"""Mean-field dense CRF (counterpart of ``drn_wsod_tpu/ops/crf.py``).

Both entry points are XLA in the JAX package, so they are plain torch ops
here, batched over images: probabilities are (B, H, W, L), images
(B, H, W, 3).

``crf_forward`` is the reference's live ``dense_crf`` semantics: unary
``-log(clip(p, 1e-5))``; kernel stds scaled by ``size_std / max(H, W)``;
``Q <- softmax(-U + pos_w * (Kg x Q) + bi_w * (Kb x Q))`` with
symmetrically normalised kernels. The spatial kernel is a separable
Gaussian; the bilateral kernel is a dilated window of (2r + 1)^2 taps
weighted by full-resolution colour distances. ``crf_inference`` is the
framework's own API (log-probability unary, per-pixel normalisation, an
optional half-resolution bilateral pass).

The bilateral tap weights ``exp(-|img - shifted img|^2 / 2) * sk * inside``
depend only on the image, so each call computes them, and the symmetric
normalisation's mass, once rather than once per pass, with the same values
as the JAX package's per-pass recomputation. The JAX package shifts by
``roll`` and zeroes the wrapped taps by the inside mask; here each tap
reads a zero-padded view, which gives the same products, and the taps are
summed in the same order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .resize import resize_linear


def _gaussian_kernel1d(sigma: float, radius: int,
                       device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _blur(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian of (B, H, W, C) maps with zero padding: along H,
    then along W."""
    B, H, W, C = x.shape
    r = (k.numel() - 1) // 2
    xx = x.permute(0, 3, 1, 2).reshape(B * C, 1, H, W)
    out = F.conv2d(xx, k.reshape(1, 1, -1, 1), padding=(r, 0))
    out = F.conv2d(out, k.reshape(1, 1, 1, -1), padding=(0, r))
    return out.reshape(B, C, H, W).permute(0, 2, 3, 1)


def _spatial_message(q: torch.Tensor, sigma: float, radius: int,
                     normalize: str = "pixel") -> torch.Tensor:
    """Gaussian-filtered beliefs of (B, H, W, C) ``q``. ``"pixel"``: divided
    by the filtered mass; ``"sym"``: ``n * (K x (n * q))`` with
    ``n = 1 / sqrt(K x 1)``."""
    k = _gaussian_kernel1d(sigma, radius, q.device)
    mass = _blur(torch.ones_like(q[:1, ..., :1]), k)
    if normalize == "sym":
        n = torch.rsqrt(mass.clamp(min=1e-20))
        return n * _blur(n * q, k)
    return _blur(q, k) / mass.clamp(min=1e-6)


def _taps(radius: int, stride: int):
    """(dy, dx) of each window tap, in the JAX package's summation order."""
    return [(ky * stride, kx * stride)
            for ky in range(-radius, radius + 1)
            for kx in range(-radius, radius + 1)]


def _shifted(x: torch.Tensor, pad: int, dy: int, dx: int) -> torch.Tensor:
    """View of zero-padded (B, H + 2 pad, W + 2 pad, C) ``x`` holding
    ``x[y - dy, x - dx]`` at (y, x), zero outside the map."""
    H, W = x.shape[1] - 2 * pad, x.shape[2] - 2 * pad
    return x[:, pad - dy:pad - dy + H, pad - dx:pad - dx + W]


def _pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, 0, pad, pad, pad, pad))


def _bilateral_weights(img: torch.Tensor, sigma_spatial: float,
                       radius: int, stride: int = 1) -> list:
    """Each tap's weight ``exp(-0.5 * |img - shifted img|^2) * sk * inside``
    for (B, H, W, 3) ``img`` already divided by sigma_color: a list of
    (dy, dx, (B, H, W, 1) weight)."""
    _, H, W, _ = img.shape
    pad = radius * stride
    padded = _pad(img, pad)
    yy = torch.arange(H, device=img.device)[:, None, None]
    xx = torch.arange(W, device=img.device)[None, :, None]
    out = []
    for dy, dx in _taps(radius, stride):
        sk = math.exp(-0.5 * (dy ** 2 + dx ** 2) / sigma_spatial ** 2)
        inside = (((yy - dy) >= 0) & ((yy - dy) < H)
                  & ((xx - dx) >= 0) & ((xx - dx) < W))
        d2 = ((img - _shifted(padded, pad, dy, dx)) ** 2).sum(
            -1, keepdim=True)
        out.append((dy, dx, torch.exp(-0.5 * d2) * sk * inside))
    return out


def _bilateral_raw_filter(q: torch.Tensor, weights: list,
                          pad: int) -> torch.Tensor:
    """Unnormalised windowed bilateral filter of (B, H, W, C) ``q``: the sum
    over taps, in order, of each tap's weight times the shifted beliefs."""
    padded = _pad(q, pad)
    msg = torch.zeros_like(q)
    for dy, dx, w in weights:
        msg.add_(w * _shifted(padded, pad, dy, dx))
    return msg


class _Bilateral:
    """A bilateral message of one image batch, its tap weights (and, for
    ``"sym"``, its normalisation) computed once."""

    def __init__(self, image: torch.Tensor, sigma_spatial: float,
                 sigma_color: float, radius: int, normalize: str = "pixel",
                 stride: int = 1):
        img = image.float() / sigma_color
        self.pad = radius * stride
        self.normalize = normalize
        self.weights = _bilateral_weights(img, sigma_spatial, radius, stride)
        if normalize == "sym":
            ones = torch.ones_like(img[..., :1])
            mass = _bilateral_raw_filter(ones, self.weights, self.pad)
            self.n = torch.rsqrt(mass.clamp(min=1e-20))

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        if self.normalize == "sym":
            return self.n * _bilateral_raw_filter(self.n * q, self.weights,
                                                  self.pad)
        # filter the beliefs and the all-ones mass channel together
        C = q.shape[-1]
        both = _bilateral_raw_filter(
            torch.cat([q, torch.ones_like(q[..., :1])], -1), self.weights,
            self.pad)
        return both[..., :C] / both[..., C:].clamp(min=1e-6)


def _bilateral_message(q: torch.Tensor, image: torch.Tensor,
                       sigma_spatial: float, sigma_color: float,
                       radius: int, normalize: str = "pixel",
                       stride: int = 1) -> torch.Tensor:
    """Colour-weighted window filtering of (B, H, W, C) ``q`` against
    (B, H, W, 3) ``image``; ``normalize`` as in ``_spatial_message``."""
    return _Bilateral(image, sigma_spatial, sigma_color, radius, normalize,
                      stride)(q)


def crf_inference(unary: torch.Tensor, image: torch.Tensor,
                  num_iters: int = 5, spatial_weight: float = 3.0,
                  spatial_sigma: float = 3.0, spatial_radius: int = 5,
                  bilateral_weight: float = 5.0,
                  bilateral_sigma_spatial: float = 10.0,
                  bilateral_sigma_color: float = 13.0,
                  bilateral_radius: int = 3, downsample: int = 2,
                  compat: float = 1.0) -> torch.Tensor:
    """Mean-field CRF of (B, H, W, L) class probabilities ``unary``
    (renormalised) against (B, H, W, 3) pixels 0-255: -> (B, H, W, L)
    refined probabilities."""
    B, H, W, L = unary.shape
    log_unary = torch.log(unary.float().clamp(min=1e-8))
    small_img = image.float()
    if downsample > 1:
        h2, w2 = H // downsample, W // downsample
        small_img = resize_linear(small_img, (B, h2, w2, image.shape[-1]))
    bilateral = _Bilateral(small_img, bilateral_sigma_spatial,
                           bilateral_sigma_color, bilateral_radius)
    q = torch.softmax(log_unary, -1)
    for _ in range(num_iters):
        sp = _spatial_message(q, spatial_sigma, spatial_radius)
        if downsample > 1:
            q_small = resize_linear(q, (B, h2, w2, L))
            bl = resize_linear(bilateral(q_small), (B, H, W, L))
        else:
            bl = bilateral(q)
        pairwise = compat * (spatial_weight * sp + bilateral_weight * bl)
        q = torch.softmax(log_unary + pairwise, -1)
    return q


def crf_forward(probs: torch.Tensor, image: torch.Tensor, max_iter: int = 10,
                size_std: float = 500.0, pos_w: float = 3.0,
                pos_xy_std: float = 3.0, bi_w: float = 10.0,
                bi_xy_std: float = 80.0, bi_rgb_std: float = 13.0,
                bilateral_radius: int = 4,
                spatial_radius: int = 5) -> torch.Tensor:
    """The reference's live dense CRF on (B, H, W, L) label probabilities
    against (B, H, W, 3) pixels 0-255: -> (B, H, W, L) refined
    probabilities (Q itself, no clamp). The bilateral window's taps are
    spaced ``round(sigma / 2)`` apart over +-2 sigma."""
    _, H, W, _ = probs.shape
    scale = size_std / max(H, W)
    sigma_pos = pos_xy_std / scale
    sigma_bi = bi_xy_std / scale
    log_p = torch.log(probs.float().clamp(min=1e-5))
    q = torch.softmax(log_p, -1)
    stride = max(1, int(round(sigma_bi / 2.0)))
    pos_radius = min(spatial_radius, max(1, int(2 * sigma_pos + 1)))
    bilateral = _Bilateral(image, sigma_bi, bi_rgb_std, bilateral_radius,
                           normalize="sym", stride=stride)
    for _ in range(max_iter):
        sp = _spatial_message(q, sigma_pos, pos_radius, normalize="sym")
        bl = bilateral(q)
        q = torch.softmax(log_p + pos_w * sp + bi_w * bl, -1)
    return q
