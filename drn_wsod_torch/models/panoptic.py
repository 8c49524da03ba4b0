"""PanopticFPN, joint instance detection and semantic segmentation
(counterpart of ``drn_wsod_tpu/models/panoptic.py``): the FPN backbone
feeds (a) a Fast R-CNN instance branch with the Mask R-CNN head over the
batch's proposals and (b) the ``SemSegFPNHead``. The instance losses are
scaled by ``instance_loss_weight``, the semantic one by
``sem_loss_weight``; the evaluation fuses both outputs on the host
(``evaluation/panoptic_eval.py``).

As in the JAX package, the instance branch trains on the proposals the
batch carries: the sampler adds no GT boxes, so a batch without live
proposals (the panoptic YAML names no proposal file while
``MODEL.LOAD_PROPOSALS`` is on) trains that branch on no slot. Its pools
are ROIAlignV2 with sampling ratio 2 from each box's assigned level,
unmasked, and the mask head pools at ``mask_pooler_resolution`` (14,
whatever ``ROI_MASK_HEAD`` says).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.poolers import multilevel_roi_pool
from ..parallel import context
from ..structures import boxes as box_ops
from ..structures.batch import WSODBatch
from .dense import PyramidModel, nchw
from .heads import fast_rcnn as fast_rcnn_lib
from .heads.seg import MaskRCNNHead, SemSegFPNHead, mask_loss, sem_seg_loss
from .meta_arch import GeneralizedRCNNWSL, mask_targets
from .semantic_seg import stride_targets


class PanopticFPN(PyramidModel):
    """Parameter names: ``backbone.*``, ``box_head.fc1``,
    ``box_predictor.cls_score``, ``mask_head.mask_fcn1``,
    ``sem_seg_head.p2.0``."""

    def __init__(self, backbone: nn.Module, *,
                 pyramid_strides: Sequence[Tuple[str, int]] = (
                     ("p2", 4), ("p3", 8), ("p4", 16), ("p5", 32)),
                 sem_in_features: Sequence[str] = ("p2", "p3", "p4", "p5"),
                 sem_strides: Sequence[int] = (4, 8, 16, 32),
                 num_classes: int = 80, sem_num_classes: int = 54,
                 common_stride: int = 4, sem_conv_dim: int = 128,
                 pooler_resolution: int = 7, mask_pooler_resolution: int = 14,
                 mask_on: bool = True, instance_loss_weight: float = 1.0,
                 sem_loss_weight: float = 0.5,
                 reg_weights: Sequence[float] = (10.0, 10.0, 5.0, 5.0),
                 pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
                 pixel_std: Sequence[float] = (57.375, 57.12, 58.395),
                 dtype: torch.dtype = torch.float32):
        super().__init__(backbone, pixel_mean, pixel_std, dtype)
        self.pyramid_strides = tuple(pyramid_strides)
        self.sem_in_features = tuple(sem_in_features)
        self.num_classes = num_classes
        self.common_stride = common_stride
        self.pooler_resolution = pooler_resolution
        self.mask_pooler_resolution = mask_pooler_resolution
        self.mask_on = mask_on
        self.instance_loss_weight = instance_loss_weight
        self.sem_loss_weight = sem_loss_weight
        self.reg_weights = tuple(reg_weights)
        C = backbone.feature_channels[self.pyramid_strides[0][0]]
        R = pooler_resolution
        self.box_head = fast_rcnn_lib.FastRCNNConvFCHead(R * R * C,
                                                         (1024, 1024), dtype)
        self.box_predictor = fast_rcnn_lib.FastRCNNOutputLayers(
            1024, num_classes, False, dtype=dtype)
        if mask_on:
            self.mask_head = MaskRCNNHead(C, num_classes, dtype=dtype)
        self.sem_seg_head = SemSegFPNHead(
            [backbone.feature_channels[f] for f in self.sem_in_features],
            self.sem_in_features, sem_strides, sem_num_classes, common_stride,
            sem_conv_dim, dtype=dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        self.init_backbone(generator)
        for head in (self.box_head, self.box_predictor,
                     getattr(self, "mask_head", None), self.sem_seg_head):
            if head is not None:
                head.init_weights(generator)

    # ------------------------------------------------------------------ parts
    def pool(self, feats: Dict[str, torch.Tensor], boxes: torch.Tensor,
             resolution: int) -> torch.Tensor:
        """(B, S, 4) boxes -> (B, S, r, r, C), each from its assigned
        level by ROIAlignV2."""
        strides = dict(self.pyramid_strides)
        names = [n for n, _ in self.pyramid_strides]
        return torch.stack([multilevel_roi_pool(
            {n: feats[n][i] for n in names}, strides, boxes[i], names,
            resolution) for i in range(boxes.shape[0])])

    def sem_logits(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.sem_seg_head([nchw(feats[f])
                                  for f in self.sem_in_features])

    def box_outputs(self, feats, boxes: torch.Tensor):
        """(B, S, C+1) class logits and (B, S, 4C) deltas of the boxes."""
        B, S = boxes.shape[:2]
        h = self.box_head(self.pool(feats, boxes, self.pooler_resolution)
                          .reshape(B * S, -1))
        cls_logits, deltas = self.box_predictor(h)
        return cls_logits.reshape(B, S, -1), deltas.reshape(B, S, -1)

    def mask_logits(self, feats, boxes: torch.Tensor) -> torch.Tensor:
        """(B * S, 2r, 2r, num_classes) mask logits of the boxes."""
        B, S = boxes.shape[:2]
        mr = self.mask_pooler_resolution
        return self.mask_head(self.pool(feats, boxes, mr).reshape(
            B * S, mr, mr, -1))

    # ------------------------------------------------------------------ train
    def forward(self, batch: WSODBatch, *, train: bool = True,
                generator: Optional[torch.Generator] = None, **_
                ) -> Dict[str, torch.Tensor]:
        """``loss_sem_seg`` where the batch has ``sem_seg`` (ignore value
        255, as the JAX model takes it), ``loss_cls`` and ``loss_box_reg``
        on 512 sampled proposal slots an image (the sampler's keys from
        ``generator``), ``loss_mask`` under ``mask_on`` where the batch has
        ``gt_masks``."""
        if generator is None:
            raise ValueError("the PanopticFPN sampler needs a generator")
        batch = self.sanitize(batch)
        feats = self.features(batch.image)
        losses: Dict[str, torch.Tensor] = {}
        sem = self.sem_logits(feats)
        if batch.sem_seg is not None:
            losses["loss_sem_seg"] = self.sem_loss_weight * sem_seg_loss(
                sem, stride_targets(batch.sem_seg, sem, self.common_stride))

        fg_keys, bg_keys = fast_rcnn_lib.draw_sampling_keys(
            batch.proposal_mask.shape, generator, batch.proposals.device)
        sampled = fast_rcnn_lib.subsample_proposals(
            batch.proposals, batch.proposal_mask, batch.gt_boxes,
            batch.gt_classes, batch.gt_valid, fg_keys, bg_keys)
        boxes = batch.proposals.gather(
            1, sampled.indices[..., None].expand(-1, -1, 4))
        cls_logits, deltas = self.box_outputs(feats, boxes)
        lc, lb = fast_rcnn_lib.fast_rcnn_losses(
            cls_logits, deltas, batch.proposals, sampled, self.num_classes,
            self.reg_weights)
        w = self.instance_loss_weight
        losses["loss_cls"] = w * context.mean(lc)
        losses["loss_box_reg"] = w * context.mean(lb)

        if self.mask_on and batch.gt_masks is not None:
            B, S = boxes.shape[:2]
            logits = self.mask_logits(feats, boxes)
            m = logits.shape[1]
            targets = mask_targets(batch.gt_masks, boxes,
                                   GeneralizedRCNNWSL.match_gt(batch, boxes),
                                   m)
            fg = (sampled.gt_class >= 0) & sampled.valid
            losses["loss_mask"] = w * mask_loss(
                logits, sampled.gt_class.reshape(B * S),
                targets.reshape(B * S, m, m), fg.reshape(B * S))
        return losses

    # -------------------------------------------------------------- inference
    @torch.inference_mode()
    def inference_scores(self, batch: WSODBatch, feats=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The instance branch's (B, P, C+1) softmax scores (padded rows
        zero) and (B, P, 4C) decoded boxes, from ``feats`` where the caller
        computed ``features(batch.image)`` on a sanitized batch."""
        if feats is None:
            batch = self.sanitize(batch)
            feats = self.features(batch.image)
        cls_logits, deltas = self.box_outputs(feats, batch.proposals)
        boxes = box_ops.apply_deltas(deltas, batch.proposals, self.reg_weights)
        return (torch.where(batch.proposal_mask[..., None],
                            torch.softmax(cls_logits, -1), 0.0), boxes)

    @torch.inference_mode()
    def predict_masks(self, feats, boxes: torch.Tensor,
                      classes: torch.Tensor) -> torch.Tensor:
        """(B, D, 2r, 2r) mask probabilities of each (B, D) box's class
        (the JAX model's ``mask_probs``), from ``feats``."""
        if not self.mask_on:
            raise ValueError("predict_masks needs MASK_ON")
        B, D = boxes.shape[:2]
        logits = self.mask_logits(feats, boxes)
        m = logits.shape[1]
        logits = logits.reshape(B, D, m, m, -1)
        cls = classes.long().clamp(0, self.num_classes - 1)
        sel = torch.gather(logits, -1,
                           cls[:, :, None, None, None].expand(B, D, m, m, 1))
        return torch.sigmoid(sel[..., 0])

    @torch.inference_mode()
    def semantic_logits(self, batch: WSODBatch) -> torch.Tensor:
        """(B, H/cs, W/cs, S) semantic logits (a backbone pass of their
        own, as in the JAX package)."""
        return self.sem_logits(self.features(batch.image))
