"""RetinaNet, the single-stage dense detector (counterpart of
``drn_wsod_tpu/models/retinanet.py``).

Shared class and box towers of 3x3 convs over the FPN levels, a fixed
anchor grid per level (``proposal_generator.generate_anchors``), anchors
labelled by IoU with low-quality matches allowed, sigmoid focal loss over
the anchors that are not ignored and smooth-L1 over the foreground ones.
Inference keeps each level's top ``topk_candidates`` anchors by their best
class probability, with their full class rows, for the shared
per-class NMS.

What the JAX package does and this copies:
  * the losses are divided by ``max(1, number of foreground anchors)``
    summed over the batch, not by Detectron2's moving average of it;
  * the anchors' centres sit at ``(i + 0.5) * stride``;
  * a level's candidates are anchors ranked by their best class, not
    (anchor, class) pairs, ties to the lower index as ``jax.lax.top_k``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.matcher import match
from ..parallel import context
from ..structures import boxes as box_ops
from ..structures.batch import WSODBatch
from .dense import PyramidModel, nchw
from .layers import Conv2d
from .proposal_generator import generate_anchors


class RetinaNetHead(nn.Module):
    """``cls_subnet`` and ``bbox_subnet``, each ``num_convs`` 3x3 convs of
    ``conv_dim`` with ReLU in ``dtype`` (Detectron2's Sequential indices 0,
    2, ...), then ``cls_score`` (A * C) and ``bbox_pred`` (A * 4), 3x3 convs
    in float32. Weights N(0, 0.01), biases 0 but ``cls_score``'s, which
    starts at ``-log((1 - prior_prob) / prior_prob)``."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int,
                 num_convs: int = 4, conv_dim: int = 256,
                 prior_prob: float = 0.01, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.prior_prob = prior_prob
        for name in ("cls_subnet", "bbox_subnet"):
            layers: List[nn.Module] = []
            for i in range(num_convs):
                layers += [Conv2d(in_channels if i == 0 else conv_dim,
                                  conv_dim, 3, dtype=dtype), nn.ReLU()]
            self.add_module(name, nn.Sequential(*layers))
        self.cls_score = Conv2d(conv_dim, num_anchors * num_classes, 3,
                                dtype=torch.float32)
        self.bbox_pred = Conv2d(conv_dim, num_anchors * 4, 3,
                                dtype=torch.float32)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()
        self.cls_score.bias.fill_(
            -math.log((1 - self.prior_prob) / self.prior_prob))

    def forward(self, feats: Sequence[torch.Tensor]
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """NCHW maps -> per level (cls (B, A*C, H, W), box (B, A*4, H, W)),
        both float32."""
        return [(self.cls_score(self.cls_subnet(f)),
                 self.bbox_pred(self.bbox_subnet(f))) for f in feats]


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float, gamma: float) -> torch.Tensor:
    """Elementwise sigmoid focal loss, written as the JAX function writes
    it: ``max(x, 0) - x * t + log1p(exp(-|x|))`` times ``(1 - p_t) **
    gamma``, times ``alpha * t + (1 - alpha) * (1 - t)`` where alpha >= 0."""
    p = torch.sigmoid(logits)
    ce = (logits.clamp(min=0) - logits * targets
          + torch.log1p(torch.exp(-logits.abs())))
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return loss


class RetinaNet(PyramidModel):
    """The dense one-stage detector over an FPN backbone. Parameter names
    are Detectron2's (``backbone.*``, ``head.cls_subnet.0``,
    ``head.cls_score``)."""

    def __init__(self, backbone: nn.Module, *,
                 in_features: Sequence[str] = ("p3", "p4", "p5", "p6"),
                 strides: Sequence[int] = (8, 16, 32, 64),
                 anchor_sizes: Sequence[Sequence[float]] = (
                     (32.0, 40.0, 51.0), (64.0, 81.0, 102.0),
                     (128.0, 161.0, 203.0), (256.0, 323.0, 406.0)),
                 aspect_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 num_classes: int = 80, num_convs: int = 4,
                 prior_prob: float = 0.01,
                 iou_thresholds: Sequence[float] = (0.4, 0.5),
                 iou_labels: Sequence[int] = (0, -1, 1),
                 focal_alpha: float = 0.25, focal_gamma: float = 2.0,
                 smooth_l1_beta: float = 0.1,
                 reg_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 topk_candidates: int = 1000,
                 pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
                 pixel_std: Sequence[float] = (57.375, 57.12, 58.395),
                 dtype: torch.dtype = torch.float32):
        super().__init__(backbone, pixel_mean, pixel_std, dtype)
        self.in_features = tuple(in_features)
        self.strides = tuple(strides)
        self.anchor_sizes = tuple(tuple(s) for s in anchor_sizes)
        self.aspect_ratios = tuple(aspect_ratios)
        self.num_classes = num_classes
        self.iou_thresholds = tuple(iou_thresholds)
        self.iou_labels = tuple(iou_labels)
        self.focal_alpha, self.focal_gamma = focal_alpha, focal_gamma
        self.smooth_l1_beta = smooth_l1_beta
        self.reg_weights = tuple(reg_weights)
        self.topk_candidates = topk_candidates
        self.head = RetinaNetHead(
            backbone.feature_channels[self.in_features[0]], num_classes,
            len(self.aspect_ratios) * len(self.anchor_sizes[0]), num_convs,
            prior_prob=prior_prob, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.init_backbone(generator)
        self.head.init_weights(generator)

    def dense(self, feats: Dict[str, torch.Tensor]):
        """{level: NHWC map} -> per-anchor (B, N, C) logits and (B, N, 4)
        deltas (float32), the (N, 4) anchors over the levels, and each
        level's anchor count."""
        maps = [feats[f] for f in self.in_features]
        outs = self.head([nchw(f) for f in maps])
        B = maps[0].shape[0]
        logits, deltas, anchors = [], [], []
        for (cls, box), f, stride, sizes in zip(outs, maps, self.strides,
                                                self.anchor_sizes):
            logits.append(cls.permute(0, 2, 3, 1).reshape(
                B, -1, self.num_classes))
            deltas.append(box.permute(0, 2, 3, 1).reshape(B, -1, 4))
            anchors.append(generate_anchors(f.shape[1:3], stride, sizes,
                                            self.aspect_ratios, f.device))
        return (torch.cat(logits, 1), torch.cat(deltas, 1),
                torch.cat(anchors, 0), [a.shape[0] for a in anchors])

    def forward(self, batch: WSODBatch, *, train: bool = True,
                generator: Optional[torch.Generator] = None, **_
                ) -> Dict[str, torch.Tensor]:
        """``loss_cls`` (focal) and ``loss_box_reg`` (smooth-L1), each summed
        over the batch's anchors and divided by ``max(1, foreground
        anchors)``."""
        logits, deltas, anchors, _ = self.dense(self.features(batch.image))
        quality = box_ops.pairwise_iou(batch.gt_boxes, anchors)  # (B, G, N)
        midx, mlab = match(quality, batch.gt_valid,
                           list(self.iou_thresholds), list(self.iou_labels),
                           allow_low_quality=True)
        fg = mlab == 1
        valid = mlab >= 0
        gt_cls = batch.gt_classes.long().gather(1, midx)
        tgt_cls = F.one_hot(gt_cls, self.num_classes).float() * fg[..., None]
        cls_loss = sigmoid_focal_loss(logits, tgt_cls, self.focal_alpha,
                                      self.focal_gamma)
        cls_loss = (cls_loss * valid[..., None]).sum((1, 2))

        gt_boxes = batch.gt_boxes.gather(1, midx[..., None].expand(-1, -1, 4))
        diff = (deltas - box_ops.get_deltas(anchors, gt_boxes,
                                            self.reg_weights)).abs()
        beta = self.smooth_l1_beta
        l1 = (torch.where(diff < beta, 0.5 * diff ** 2 / beta,
                          diff - 0.5 * beta) if beta > 0 else diff)
        box_loss = (l1 * fg[..., None]).sum((1, 2))
        norm = context.global_sum(fg.sum().float()).clamp(min=1.0)
        return {"loss_cls": cls_loss.sum() / norm,
                "loss_box_reg": box_loss.sum() / norm}

    @torch.inference_mode()
    def inference_scores(self, batch: WSODBatch, feats=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per level the top ``min(topk_candidates, n)`` anchors by best
        class probability -> (B, K, C+1) sigmoid scores (background column
        zero) and (B, K, 4) decoded boxes clipped to each image, from
        ``feats`` where the caller computed ``features(batch.image)``."""
        if feats is None:
            feats = self.features(batch.image)
        logits, deltas, anchors, sizes = self.dense(feats)
        probs = torch.sigmoid(logits)
        boxes = box_ops.apply_deltas(deltas, anchors[None], self.reg_weights)
        boxes = box_ops.clip(boxes, batch.image_hw[:, None, :])
        out_scores, out_boxes = [], []
        start = 0
        for n in sizes:
            p, b = probs[:, start:start + n], boxes[:, start:start + n]
            k = min(self.topk_candidates, n)
            idx = torch.sort(p.amax(-1), dim=1, descending=True,
                             stable=True).indices[:, :k]
            out_scores.append(p.gather(1, idx[..., None].expand(
                -1, -1, p.shape[-1])))
            out_boxes.append(b.gather(1, idx[..., None].expand(-1, -1, 4)))
            start += n
        scores = torch.cat(out_scores, 1)
        return (torch.cat([scores, scores.new_zeros(scores.shape[:-1] + (1,))],
                          -1), torch.cat(out_boxes, 1))
