"""Anchors and the region proposal networks (counterpart of
``drn_wsod_tpu/models/proposal_generator.py``).

A level's anchors are a fixed grid: the cell anchors of every (size,
aspect ratio[, angle]) triple, centred on each feature cell's centre. The
RPN (and RRPN, over rotated boxes) is one shared head over the levels, a
sampled loss per image, and per-level proposal selection with
static top-k counts and validity masks, as in the JAX package, whose
WSOD models take precomputed proposals and call these functions only
from its tests.

The samplers take their random keys as arguments (two uniforms in [0, 1)
an anchor, see :func:`draw_rpn_keys`), so that a test can feed JAX's own
``jax.random.uniform`` draws; every top-k is a stable descending sort,
ties to the lower index as ``jax.lax.top_k`` takes them.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.matcher import match
from ..ops.nms import nms_mask
from ..parallel import context
from ..structures import boxes as box_ops
from ..structures.rotated_boxes import (apply_deltas_rotated,
                                        get_deltas_rotated, nms_rotated,
                                        pairwise_iou_rotated)
from .layers import Conv2d, lecun_normal_


def generate_anchors(feature_hw: Tuple[int, int], stride: int,
                     sizes: Sequence[float], aspect_ratios: Sequence[float],
                     device=None) -> torch.Tensor:
    """Dense anchor grid of one level -> (Hf * Wf * A, 4) float32 XYXY, the
    A = len(sizes) * len(aspect_ratios) anchors of a cell innermost (size
    major, ratio minor).

    As the JAX function computes them: each cell anchor's width
    ``(size**2 / ratio) ** 0.5`` and height ``ratio * width`` in Python
    doubles, rounded to float32 once; the cell centres
    ``(arange + 0.5) * stride`` in float32 (an offset of 0.5, where
    Detectron2's default is 0); centre plus cell anchor in float32."""
    cell = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = (area / ar) ** 0.5
            h = ar * w
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    cell_anchors = torch.tensor(cell, dtype=torch.float32, device=device)

    Hf, Wf = feature_hw
    shifts_x = (torch.arange(Wf, dtype=torch.float32, device=device)
                + 0.5) * stride
    shifts_y = (torch.arange(Hf, dtype=torch.float32, device=device)
                + 0.5) * stride
    sy, sx = torch.meshgrid(shifts_y, shifts_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    return (shifts + cell_anchors[None]).reshape(-1, 4)


class StandardRPNHead(nn.Module):
    """A 3x3 conv of ``conv_dim`` with ReLU in ``dtype``, then the 1x1
    ``objectness_logits`` (A) and ``anchor_deltas`` (A * ``box_dim``: 4,
    or 5 for rotated boxes) in float32, shared over the levels. Init as flax draws it: the 3x3 kernel
    ``lecun_normal``, the 1x1 kernels N(0, 0.01), biases 0."""

    def __init__(self, in_channels: int, num_anchors: int,
                 conv_dim: int = 256, dtype: torch.dtype = torch.float32,
                 box_dim: int = 4):
        super().__init__()
        self.conv = Conv2d(in_channels, conv_dim, 3, dtype=dtype)
        self.objectness_logits = Conv2d(conv_dim, num_anchors, 1,
                                        dtype=torch.float32)
        self.anchor_deltas = Conv2d(conv_dim, num_anchors * box_dim, 1,
                                    dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.conv.weight, 9 * self.conv.in_channels, generator)
        for m in (self.objectness_logits, self.anchor_deltas):
            m.weight.normal_(0.0, 0.01, generator=generator)
        for m in (self.conv, self.objectness_logits, self.anchor_deltas):
            m.bias.zero_()

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """NCHW maps -> per level (objectness (B, A, H, W), deltas (B,
        A * box_dim, H, W)), both float32."""
        outs = []
        for f in feats:
            t = F.relu(self.conv(f))
            outs.append((self.objectness_logits(t), self.anchor_deltas(t)))
        return outs


def draw_rpn_keys(n: int, generator: torch.Generator, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sampler's keys for ``n`` anchors: two (n,) float32 uniforms in
    [0, 1), the foreground's then the background's."""
    keys = torch.rand((2, n), generator=generator, device=device)
    return keys[0], keys[1]


def _top(x: torch.Tensor, k: int):
    values, indices = torch.sort(x, descending=True, stable=True)
    return values[:k], indices[:k]


def _sampled_losses(midx, mlab, keys, anchors, obj_logits, pred_deltas,
                    gt_boxes, encode, batch_size, positive_fraction):
    """The objectness and box losses of ``batch_size`` anchors sampled by
    ``keys``: at most ``batch_size * positive_fraction`` foreground ones
    (label 1) of highest first key, the rest background (label 0) of
    highest second key; each loss summed over the sampled slots and
    divided by their count (at least 1). Returns the sampled indices,
    their validity and foreground flags, and the two losses."""
    num_pos = int(batch_size * positive_fraction)
    fg_keys, bg_keys = keys
    pv, pi = _top(torch.where(mlab == 1, fg_keys, -1.0), num_pos)
    nv, ni = _top(torch.where(mlab == 0, bg_keys, -1.0),
                  batch_size - num_pos)
    sel = torch.cat([pi, ni])
    sel_valid = torch.cat([pv >= 0, nv >= 0])
    sel_pos = torch.cat([pv >= 0, torch.zeros_like(nv, dtype=torch.bool)])

    logits = obj_logits[sel]
    bce = torch.where(sel_pos, -F.logsigmoid(logits), -F.logsigmoid(-logits))
    bce = torch.where(sel_valid, bce, 0.0)
    denom = sel_valid.sum().clamp(min=1)
    loss_obj = bce.sum() / denom

    tgt = encode(anchors[sel], gt_boxes[midx[sel]])
    diff = (pred_deltas[sel] - tgt).abs()
    diff = torch.where((sel_pos & sel_valid)[:, None], diff, 0.0)
    loss_loc = diff.sum() / denom
    return sel, sel_valid, sel_pos, loss_obj, loss_loc


def rpn_losses(anchors: torch.Tensor, obj_logits: torch.Tensor,
               pred_deltas: torch.Tensor, gt_boxes: torch.Tensor,
               gt_valid: torch.Tensor, keys: Tuple[torch.Tensor, torch.Tensor],
               batch_size: int = 256, positive_fraction: float = 0.5,
               iou_thresholds=(0.3, 0.7), iou_labels=(0, -1, 1),
               reg_weights=(1.0, 1.0, 1.0, 1.0), return_sampled: bool = False):
    """One image's RPN losses: anchors (N, 4) matched to the (G, 4) GT by
    IoU (no low-quality matches, as the JAX function calls the matcher),
    ``batch_size`` of them sampled by ``keys``, binary cross-entropy on
    their objectness and L1 on the foreground's deltas (N, 4). Returns
    (loss_obj, loss_loc), and the sampled (indices, valid, foreground)
    where ``return_sampled``."""
    quality = box_ops.pairwise_iou(gt_boxes, anchors)
    midx, mlab = match(quality, gt_valid, list(iou_thresholds),
                       list(iou_labels))
    sel, sv, sp, lo, ll = _sampled_losses(
        midx, mlab, keys, anchors, obj_logits, pred_deltas, gt_boxes,
        lambda a, g: box_ops.get_deltas(a, g, reg_weights), batch_size,
        positive_fraction)
    return (lo, ll, (sel, sv, sp)) if return_sampled else (lo, ll)


def select_proposals(anchors: torch.Tensor, obj_logits: torch.Tensor,
                     pred_deltas: torch.Tensor, image_hw,
                     pre_nms_topk: int = 2000, post_nms_topk: int = 1000,
                     nms_thresh: float = 0.7, min_size: float = 0.0,
                     reg_weights=(1.0, 1.0, 1.0, 1.0)):
    """One image and level: decode, clip to ``image_hw`` (h, w), the top
    ``pre_nms_topk`` by objectness, non-empty and finite, NMS, then the
    top ``post_nms_topk`` kept. Returns (boxes (post, 4), scores (post,),
    valid (post,)), the scores 0 where not valid."""
    boxes = box_ops.apply_deltas(pred_deltas, anchors, reg_weights)
    boxes = box_ops.clip(boxes, image_hw)
    k = min(pre_nms_topk, boxes.shape[0])
    top_scores, top_idx = _top(obj_logits, k)
    top_boxes = boxes[top_idx]
    ok = box_ops.nonempty(top_boxes, min_size) & torch.isfinite(top_scores)
    keep = nms_mask(top_boxes, top_scores, ok, nms_thresh)
    return _after_nms(top_boxes, top_scores, keep, min(post_nms_topk, k))


def _after_nms(top_boxes, top_scores, keep, k2):
    kept_scores = torch.where(keep, top_scores, -math.inf)
    final_scores, fi = _top(kept_scores, k2)
    valid = torch.isfinite(final_scores)
    return top_boxes[fi], torch.where(valid, final_scores, 0.0), valid


def generate_rotated_anchors(feature_hw: Tuple[int, int], stride: int,
                             sizes: Sequence[float],
                             aspect_ratios: Sequence[float],
                             angles: Sequence[float],
                             device=None) -> torch.Tensor:
    """Dense rotated anchor grid of one level -> (Hf * Wf * A, 5) float32
    (cx, cy, w, h, angle_deg), A = sizes x ratios x angles innermost
    (size major, angle minor); widths and heights as
    :func:`generate_anchors` computes them, centres at ``(i + 0.5) *
    stride``."""
    cell = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = (area / ar) ** 0.5
            h = ar * w
            for a in angles:
                cell.append([0.0, 0.0, w, h, float(a)])
    cell_anchors = torch.tensor(cell, dtype=torch.float32, device=device)

    Hf, Wf = feature_hw
    shifts_x = (torch.arange(Wf, dtype=torch.float32, device=device)
                + 0.5) * stride
    shifts_y = (torch.arange(Hf, dtype=torch.float32, device=device)
                + 0.5) * stride
    sy, sx = torch.meshgrid(shifts_y, shifts_x, indexing="ij")
    zeros = torch.zeros_like(sx)
    shifts = torch.stack([sx, sy, zeros, zeros, zeros],
                         dim=-1).reshape(-1, 1, 5)
    return (shifts + cell_anchors[None]).reshape(-1, 5)


def rrpn_losses(anchors: torch.Tensor, obj_logits: torch.Tensor,
                pred_deltas: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor,
                keys: Tuple[torch.Tensor, torch.Tensor],
                batch_size: int = 256, positive_fraction: float = 0.5,
                iou_thresholds=(0.3, 0.7), iou_labels=(0, -1, 1),
                reg_weights=(1.0, 1.0, 1.0, 1.0, 1.0),
                return_sampled: bool = False):
    """The RPN losses over rotated boxes: anchors (N, 5) matched to the
    (G, 5) GT by rotated IoU, low-quality matches allowed (every anchor
    tied at a GT's best IoU), deltas (N, 5)."""
    quality = pairwise_iou_rotated(gt_boxes, anchors)
    midx, mlab = match(quality, gt_valid, list(iou_thresholds),
                       list(iou_labels), allow_low_quality=True)
    sel, sv, sp, lo, ll = _sampled_losses(
        midx, mlab, keys, anchors, obj_logits, pred_deltas, gt_boxes,
        lambda a, g: get_deltas_rotated(a, g, reg_weights), batch_size,
        positive_fraction)
    return (lo, ll, (sel, sv, sp)) if return_sampled else (lo, ll)


def rpn_batch_losses(anchors: torch.Tensor, obj_logits: torch.Tensor,
                     pred_deltas: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_valid: torch.Tensor, generator: torch.Generator,
                     rotated: bool = False, **kwargs):
    """The batch's RPN (with ``rotated``, RRPN) losses: each image's
    :func:`rpn_losses` (:func:`rrpn_losses`) on its row of keys drawn for
    the batch from ``generator`` (for the global batch under a mesh shard,
    the rank's rows kept), each loss averaged over the images. anchors
    (N, 4 or 5); obj_logits (B, N); pred_deltas (B, N, 4 or 5); gt_boxes
    (B, G, 4 or 5); gt_valid (B, G). Returns (loss_obj, loss_loc)."""
    B, N = obj_logits.shape
    keys = context.draw_rows(
        lambda s: torch.rand(s, generator=generator,
                             device=obj_logits.device), (2, B, N), dim=1)
    fn = rrpn_losses if rotated else rpn_losses
    per = [fn(anchors, obj_logits[i], pred_deltas[i], gt_boxes[i],
              gt_valid[i], (keys[0, i], keys[1, i]), **kwargs)
           for i in range(B)]
    lo, ll = (torch.stack(t) for t in zip(*per))
    return context.mean(lo), context.mean(ll)


def select_proposals_rotated(anchors: torch.Tensor, obj_logits: torch.Tensor,
                             pred_deltas: torch.Tensor, image_hw,
                             pre_nms_topk: int = 2000,
                             post_nms_topk: int = 1000,
                             nms_thresh: float = 0.7,
                             reg_weights=(1.0, 1.0, 1.0, 1.0, 1.0)):
    """:func:`select_proposals` over rotated boxes: only the centres are
    clipped to the image, the extent and angle kept; a box is a candidate
    where its width and height are positive and its score finite."""
    boxes = apply_deltas_rotated(pred_deltas, anchors, reg_weights)
    h, w = float(image_hw[0]), float(image_hw[1])
    boxes = torch.cat([boxes[..., 0:1].clamp(0, w),
                       boxes[..., 1:2].clamp(0, h), boxes[..., 2:]], -1)
    k = min(pre_nms_topk, boxes.shape[0])
    top_scores, top_idx = _top(obj_logits, k)
    top_boxes = boxes[top_idx]
    ok = (top_boxes[:, 2] > 0) & (top_boxes[:, 3] > 0) & \
        torch.isfinite(top_scores)
    keep = nms_rotated(top_boxes, top_scores, ok, nms_thresh)
    return _after_nms(top_boxes, top_scores, keep, min(post_nms_topk, k))
