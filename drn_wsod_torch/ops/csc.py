"""Contextual Suppression Constraint weights (counterpart of
``drn_wsod_tpu/ops/csc.py``).

Plain torch ops on the tensors' device, batched over images and classes
where the JAX package vmaps:

  * class-peak-gradient (CPG) maps: one backward pass to the image for each
    class (the gradient of the class's proposal scores summed over
    proposals), the max |gradient| over the colour channels, normalised by
    each map's max, zero for absent classes and classes whose image
    probability is below ``tau``;
  * each map binarized at ``fg_threshold`` and summed into an integral image;
  * per RoI: frame sum / sqrt(frame area) - context sum / sqrt(context area),
    with the inner box ``roi / context_scale`` and the outer box
    ``roi * context_scale`` clipped to the image;
  * per class: positive scores over the max, negative ones over |min|, all
    ones where no score is positive; blended ``pred * W + (1 - pred)``;
    1 for absent classes and 0 for padded proposals.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..parallel import context


def integral_image(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> inclusive 2-D prefix sums. The maps are 0/1, so the
    sums are exact integers in any order."""
    return x.cumsum(-2).cumsum(-1)


def _integral_lookup(ii: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """Sums over [hs, he] x [ws, we] (inclusive) from integral images.

    ii: (N, H, W); the bounds: (N, P) int64. Returns (N, P)."""
    N, H, W = ii.shape
    flat = ii.reshape(N, H * W)

    def at(y, x, valid):
        i = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
        return torch.where(valid, flat.gather(1, i), 0.0)

    a1 = at(he, we, torch.ones_like(he, dtype=torch.bool))
    a2 = at(he, ws - 1, ws - 1 >= 0)
    a3 = at(hs - 1, we, hs - 1 >= 0)
    a4 = at(hs - 1, ws - 1, (hs - 1 >= 0) & (ws - 1 >= 0))
    return a1 - a2 - a3 + a4


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded: taken in float64 and rounded
    once (torch's vectorised float32 sqrt on the CPU can be an ulp off)."""
    return torch.sqrt(x.double()).to(x.dtype)


def csc_pool_class(cpg_binary_integral: torch.Tensor, rois: torch.Tensor,
                   area_sqrt: bool = True,
                   context_scale: float = 1.8) -> torch.Tensor:
    """Per-RoI center-surround contrast. cpg_binary_integral: (N, H, W)
    integral images; rois: (N, P, 4) XYXY image pixels. -> (N, P)."""
    N, H, W = cpg_binary_integral.shape
    r = torch.round(rois).to(torch.int64)
    ws = r[..., 0].clamp(0, W - 1)
    hs = r[..., 1].clamp(0, H - 1)
    we = r[..., 2].clamp(0, W - 1)
    he = r[..., 3].clamp(0, H - 1)

    w_roi = (we - ws).float()
    h_roi = (he - hs).float()
    wc = (we + ws).float() / 2.0
    hc = (he + hs).float() / 2.0

    def bounds(c, size, lo=None, hi=None):
        half = size / 2.0
        s, e = c - half, c + half
        if lo is not None:
            s = s.clamp(min=lo)
        if hi is not None:
            e = e.clamp(max=hi)
        return torch.round(s).to(torch.int64), torch.round(e).to(torch.int64)

    ws_i, we_i = bounds(wc, w_roi / context_scale)
    hs_i, he_i = bounds(hc, h_roi / context_scale)
    ws_o, we_o = bounds(wc, w_roi * context_scale, lo=0.0, hi=W - 1.0)
    hs_o, he_o = bounds(hc, h_roi * context_scale, lo=0.0, hi=H - 1.0)

    ii = cpg_binary_integral
    sum_roi = _integral_lookup(ii, hs, he, ws, we)
    sum_inner = _integral_lookup(ii, hs_i, he_i, ws_i, we_i)
    sum_outer = _integral_lookup(ii, hs_o, he_o, ws_o, we_o)

    def area(hs_, he_, ws_, we_):
        return ((he_ - hs_ + 1) * (we_ - ws_ + 1)).float()

    area_frame = (area(hs, he, ws, we)
                  - area(hs_i, he_i, ws_i, we_i)).clamp(min=1.0)
    area_context = (area(hs_o, he_o, ws_o, we_o)
                    - area(hs, he, ws, we)).clamp(min=1.0)
    sum_frame = sum_roi - sum_inner
    sum_context = sum_outer - sum_roi
    if area_sqrt:
        return (sum_frame / _sqrt(area_frame)
                - sum_context / _sqrt(area_context))
    return sum_frame / area_frame - sum_context / area_context


def _normalize_class_weights(w: torch.Tensor, pred: torch.Tensor
                             ) -> torch.Tensor:
    """Per-class normalisation and confidence blend. w: (N, P) scores of
    one class each; pred: (N,) its image probability."""
    max_v = w.amax(-1, keepdim=True)
    min_v = w.amin(-1, keepdim=True)
    pos_neg = (max_v > 0) & (min_v < 0)
    pos_only = (max_v > 0) & (min_v == 0)
    norm = torch.where(w > 0, w / torch.where(max_v > 0, max_v, 1.0),
                       w / torch.where(min_v < 0, -min_v, 1.0))
    out = torch.where(pos_neg | pos_only, norm, 1.0)
    pred = pred[:, None]
    return pred * out + (1.0 - pred)


def csc_forward(cpgs: torch.Tensor, labels: torch.Tensor, preds: torch.Tensor,
                rois: torch.Tensor, prop_mask: torch.Tensor,
                fg_threshold: float = 0.1, area_sqrt: bool = True,
                context_scale: float = 1.8
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CSC weights of a batch.

    cpgs: (B, C, H, W) normalised CPG maps; labels: (B, C) multi-hot;
    preds: (B, C) clamped image probabilities; rois: (B, P, 4) image-pixel
    XYXY; prop_mask: (B, P). Returns (W (B, P, C), PL (B, C), NL (B, C))."""
    B, C, H, Wd = cpgs.shape
    ii = integral_image((cpgs >= fg_threshold).float()).reshape(B * C, H, Wd)
    P = rois.shape[1]
    rois_c = rois[:, None].expand(B, C, P, 4).reshape(B * C, P, 4)
    scores = csc_pool_class(ii, rois_c, area_sqrt, context_scale)
    w = _normalize_class_weights(scores, preds.reshape(B * C))
    w = torch.where(labels.reshape(B * C, 1) > 0.5, w, 1.0)
    W = w.reshape(B, C, P).transpose(1, 2)
    W = torch.where(prop_mask[..., None], W, 0.0)
    return W, labels, torch.zeros_like(labels)


def csc_loss(scores: torch.Tensor, W: torch.Tensor, PL: torch.Tensor,
             NL: torch.Tensor, mean_loss: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CSC-weighted image BCE pair, normalised as ``wsddn_loss`` (over
    the global batch under a mesh shard). scores, W: (B, P, C); PL, NL:
    (B, C)."""
    W_pos = W.clamp(min=0.0).abs()
    W_neg = W.clamp(max=0.0).abs()
    eps = 1e-6     # the reference's clamp: 1e-20 underflows in float32
    img_pos = (scores * W_pos).sum(1).clamp(eps, 1 - eps)
    img_neg = (scores * W_neg).sum(1).clamp(eps, 1 - eps)

    def bce(p, t):
        v = -(t * torch.log(p) + (1 - t) * torch.log(1 - p))
        return ((context.mean(v) if mean_loss else v.sum())
                / context.batch_size(p.shape[0]))

    return bce(img_pos, PL), bce(img_neg, NL)


def compute_cpg_batched(score_fn: Callable[[torch.Tensor], torch.Tensor],
                        image: torch.Tensor, labels: torch.Tensor,
                        preds: torch.Tensor, tau: float = 0.7
                        ) -> torch.Tensor:
    """Class-peak-gradient maps of a batch: ``score_fn(image (B, H, W, 3))
    -> (B, P, C)``, then :func:`cpg_from_scores`."""
    image = image.detach().requires_grad_(True)
    with torch.enable_grad():
        scores = score_fn(image)
    return cpg_from_scores(scores, image, labels, preds, tau)


def cpg_from_scores(scores: torch.Tensor, image: torch.Tensor,
                    labels: torch.Tensor, preds: torch.Tensor,
                    tau: float = 0.7) -> torch.Tensor:
    """CPG maps from proposal scores (B, P, C) computed from ``image`` (B,
    H, W, 3). One backward pass per class, each with the cotangent "class
    c of every proposal": images are independent, so each image gets its
    own map. Where the scores carry no gradient to the image (a frozen
    backbone stops it), the maps are zeros, as the JAX package computes
    them. Returns (B, C, H, W) float32, max-normalised per map, zero where
    the class is absent or its ``preds`` is below ``tau``."""
    C = scores.shape[-1]
    maps = []
    for c in range(C):
        grad = None
        if scores.requires_grad:
            ct = torch.zeros_like(scores)
            ct[..., c] = 1.0
            grad, = torch.autograd.grad(scores, image, ct,
                                        retain_graph=c < C - 1,
                                        allow_unused=True)
        maps.append(image.new_zeros(image.shape[:-1]) if grad is None
                    else grad.abs().amax(-1))
    cpg = torch.stack(maps, 1).float()                     # (B, C, H, W)
    max_v = cpg.amax((2, 3), keepdim=True)
    cpg = cpg / max_v.clamp(min=1e-12)
    active = (labels > 0.5) & (preds >= tau)
    return torch.where(active[..., None, None], cpg, 0.0)


def compute_cpg(score_fn: Callable[[torch.Tensor], torch.Tensor],
                image: torch.Tensor, num_classes: int, labels: torch.Tensor,
                preds: torch.Tensor, tau: float = 0.7) -> torch.Tensor:
    """One image's CPG maps: ``score_fn(image (H, W, 3)) -> (P, C)``.
    Returns (C, H, W), as :func:`compute_cpg_batched` computes them.
    ``num_classes`` is unused (the scores give C), as in the JAX
    function."""
    del num_classes
    return compute_cpg_batched(lambda im: score_fn(im[0])[None], image[None],
                               labels[None], preds[None], tau)[0]
