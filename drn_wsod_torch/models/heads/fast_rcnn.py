"""The supervised Fast R-CNN head for pseudo-GT retraining (counterpart of
``drn_wsod_tpu/models/heads/fast_rcnn.py``).

  * ``FastRCNNConvFCHead``: N fully-connected layers with ReLU over the
    (7, 7, C)-flattened pooled features (Cascade R-CNN's per-stage head);
  * ``FastRCNNOutputLayers``: class logits (C+1, background last) and box
    deltas (4, or 4 per class);
  * the proposal sampler: IoU-match each proposal to the instance GT, then
    a fixed number of slots per image, at most ``batch_size *
    positive_fraction`` foreground and the rest background, drawn at random
    without replacement. Static shapes: random keys, and the slots taken in
    descending key order. The draw (:func:`draw_sampling_keys`) is apart
    from the deterministic core (:func:`subsample_proposals`), so that the
    JAX package's keys can be fed to the core;
  * ``fast_rcnn_losses``: softmax cross-entropy over the valid slots plus
    smooth-L1 (L1 at beta 0) on the foreground slots' deltas, both divided
    by the number of valid slots.

The JAX functions are per image and vmapped; these take a leading batch
axis.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.matcher import match
from ...parallel import context
from ...structures import boxes as box_ops
from ..layers import Dense
from .oicr import RefinementOutputLayers


class FastRCNNConvFCHead(nn.Module):
    """``fc1`` ... ``fcN`` with ReLU, float32 masters computed in
    ``dtype``."""

    def __init__(self, in_features: int, fc_dims: Sequence[int] = (1024, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_features, *fc_dims]
        self.num_fc = len(fc_dims)
        for i in range(self.num_fc):
            self.add_module(f"fc{i + 1}", Dense(dims[i], dims[i + 1], dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Weights U(-sqrt(3 / fan_in), sqrt(3 / fan_in)), zero bias (flax's
        ``variance_scaling(1.0, "fan_in", "uniform")``)."""
        for i in range(self.num_fc):
            fc = getattr(self, f"fc{i + 1}")
            lim = (3.0 / fc.in_features) ** 0.5
            fc.weight.uniform_(-lim, lim, generator=generator)
            fc.bias.zero_()


class FastRCNNOutputLayers(RefinementOutputLayers):
    """``cls_score`` (C+1) and ``bbox_pred`` (4, or 4C), computed in the
    model's dtype from float32 masters and returned in float32; weights
    N(0, 0.01) and N(0, 0.001), zero bias. The same layers as an OICR
    refinement branch."""


class SampledProposals(NamedTuple):
    indices: torch.Tensor   # (B, S) int64 into the P proposals
    gt_class: torch.Tensor  # (B, S) int64 matched class; -1 background
    gt_box: torch.Tensor    # (B, S, 4) matched GT box
    valid: torch.Tensor     # (B, S) bool


def draw_sampling_keys(shape: Tuple[int, int], generator: torch.Generator,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampler's random keys: two (B, P) float32 uniforms in [0, 1),
    the foreground's then the background's, from ``generator``; drawn for
    the global batch under a mesh shard, the rank's rows kept."""
    keys = context.draw_rows(
        lambda s: torch.rand(s, generator=generator, device=device),
        (2, *shape), dim=1)
    return keys[0], keys[1]


def subsample_proposals(proposals: torch.Tensor, prop_mask: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                        gt_valid: torch.Tensor, fg_keys: torch.Tensor,
                        bg_keys: torch.Tensor, batch_size: int = 512,
                        positive_fraction: float = 0.25,
                        iou_thresholds: Sequence[float] = (0.5,),
                        iou_labels: Sequence[int] = (0, 1)
                        ) -> SampledProposals:
    """Match and subsample S = min(batch_size, P) proposal slots per image,
    given the keys.

    proposals (B, P, 4), prop_mask (B, P), gt_boxes (B, G, 4), gt_classes
    (B, G), gt_valid (B, G); fg_keys and bg_keys (B, P) in [0, 1). The
    first ``int(S * positive_fraction)`` slots take the foreground
    proposals (IoU label 1) of highest fg key, the rest the background
    proposals (label 0) of highest bg key; a slot without a proposal
    (fewer of the kind than slots) is invalid. Slots of equal key (the
    invalid ones all hold -1) are taken lowest index first, as
    ``jax.lax.top_k`` takes them: a stable descending sort, not
    ``torch.topk``."""
    P = proposals.shape[1]
    S = min(batch_size, P)
    num_pos = int(S * positive_fraction)
    quality = box_ops.pairwise_iou(gt_boxes, proposals)         # (B, G, P)
    midx, mlab = match(quality, gt_valid, list(iou_thresholds),
                       list(iou_labels))
    fg = (mlab == 1) & prop_mask
    bg = (mlab == 0) & prop_mask

    def top(keys, k):
        vals, idx = torch.sort(keys, dim=1, descending=True, stable=True)
        return vals[:, :k], idx[:, :k]

    fg_vals, fg_idx = top(torch.where(fg, fg_keys, -1.0), num_pos)
    bg_vals, bg_idx = top(torch.where(bg, bg_keys, -1.0), S - num_pos)
    idx = torch.cat([fg_idx, bg_idx], 1)
    is_fg = fg_vals >= 0
    sel_fg = torch.cat([is_fg, torch.zeros_like(bg_vals, dtype=torch.bool)],
                       1)
    sel_midx = midx.gather(1, idx)
    gt_cls = gt_classes.long().gather(1, sel_midx)
    return SampledProposals(
        indices=idx,
        gt_class=torch.where(sel_fg, gt_cls, -1),
        gt_box=gt_boxes.gather(1, sel_midx[..., None].expand(-1, -1, 4)),
        valid=torch.cat([is_fg, bg_vals >= 0], 1))


def fast_rcnn_losses(cls_logits: torch.Tensor, deltas: torch.Tensor,
                     proposals: torch.Tensor, sampled: SampledProposals,
                     num_classes: int,
                     reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0),
                     smooth_l1_beta: float = 0.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image (loss_cls, loss_box), each (B,).

    cls_logits (B, S, C+1) and deltas (B, S, R*4) of the sampled slots;
    proposals (B, P, 4), gathered at ``sampled.indices``. Background slots
    (``gt_class`` -1) take class C. Both sums run over the slots and are
    divided by max(valid slots, 1)."""
    B, S = sampled.indices.shape
    tgt = torch.where(sampled.gt_class >= 0, sampled.gt_class, num_classes)
    logp = torch.log_softmax(cls_logits, dim=-1)
    ce = -logp.gather(-1, tgt[..., None])[..., 0]
    ce = torch.where(sampled.valid, ce, 0.0)
    n_valid = sampled.valid.float().sum(1).clamp(min=1.0)
    loss_cls = ce.sum(1) / n_valid

    fg = sampled.gt_class >= 0
    sel_props = proposals.gather(1, sampled.indices[..., None].expand(-1, -1,
                                                                      4))
    gt_deltas = box_ops.get_deltas(sel_props, sampled.gt_box, reg_weights)
    R = deltas.shape[-1] // 4
    d = deltas.reshape(B, S, R, 4)
    cls_idx = sampled.gt_class.clamp(0, R - 1)
    pred = d.gather(2, cls_idx[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    diff = (pred - gt_deltas).abs()
    if smooth_l1_beta > 0:
        loss = torch.where(diff < smooth_l1_beta,
                           0.5 * diff ** 2 / smooth_l1_beta,
                           diff - 0.5 * smooth_l1_beta)
    else:
        loss = diff
    loss = torch.where((fg & sampled.valid)[..., None], loss, 0.0)
    return loss_cls, loss.sum((1, 2)) / n_valid

