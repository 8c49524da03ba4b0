"""GeneralizedRCNNWSL, the WSOD meta-architecture (counterpart of
``drn_wsod_tpu/models/meta_arch.py``).

Backbone over raw NHWC pixels, exact RoIPool over padded proposals scaled by
``(objectness + 1) * mask``, the DAN neck, then the WSDDN head and the OICR
or PCL refinement branches. ``forward`` returns the training losses (the
WSDDN image loss, or CSC's weighted pair where ``csc_w`` is given);
``proposal_scores`` the WSDDN scores CSC takes image gradients of;
``inference_scores`` the score and box matrices that feed NMS. With
``with_seg`` (WSJDS) an ASPP head over the feature map adds ``loss_seg``
from the CPG maps and, with ``seg_constraint``, the CRF's
``loss_constraint``; ``semantic_logits`` gives its logits, CRF-refined
under the constraint.

The supervised heads retrain on instance GT (pseudo-GT retraining):
``FastRCNN`` samples 512 slots per image (at most a quarter foreground),
pools them through the DAN into ``box_predictor`` and takes
``loss_cls`` and ``loss_box_reg``; ``CascadeRCNN`` runs three stages, each
its own 2-FC head and class-agnostic predictor on the previous stage's
detached, clipped boxes re-matched at the stage's IoU, with
``loss_cls_stage{k}`` and ``loss_box_reg_stage{k}``. Their sampler draws
its keys from the step's generator.

The mask and keypoint arms (Mask R-CNN, Keypoint R-CNN). With ``mask_on``
Fast R-CNN and Cascade R-CNN (on its stage-0 sample) add ``loss_mask``: the
sampled boxes pooled at ``mask_pooler_resolution`` into ``mask_head``, BCE
on each box's class channel against its matched GT mask (IoU 0.5) RoIAligned
at the head's output size (``sampling_ratio`` 2, aligned) and thresholded
at 0.5. The G masks of an image are pooled as the G channels of one map
and each box takes its match's channel: RoIAlign treats channels apart, so
the values are the JAX package's, which pools each box's mask alone. With
``keypoint_on`` Fast R-CNN adds ``loss_keypoint``, the spatial cross
entropy of ``keypoint_head``'s heatmaps at the matched GT keypoints.
``predict_masks`` and ``predict_keypoints`` take the features that
``inference_scores`` was given, so that detection computes them once.

The pools, as in the JAX package. Where the pooler is ``ROIPool`` and
``use_pallas_pooler`` (a frozen backbone, no CSC head), the forward-only
kernel K1 pools with the scale fused into its epilogue. Otherwise the
differentiable pool (``ops/roi_align.py:roi_pool``, or ``roi_align`` for
``ROIAlign`` / ``ROIAlignV2``) pools one image at a time and the scale is
two multiplies, each rounded to the map's dtype. Over an FPN
(``pyramid_strides``) ``ops/poolers.py:multilevel_roi_pool`` pools each
RoI from its assigned level. Cascade's stages pool without the
objectness scale and never through K1. A frozen backbone
(``FREEZE_AT >= 5``) runs without autograd, the counterpart of
``stop_gradient``; a trainable one carries gradients to its stages and to
the image.

The backbone runs as the JAX package's does, never in train mode: under
``NORM`` BN its BatchNorms normalise with their running statistics in
training too, and the map reaches the pool in float32 (the pool's float32
mode), whatever ``MODEL.DTYPE``; the DAN casts the pooled features back.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import csc as csc_lib
from ..ops import pcl as pcl_lib
from ..ops.crf import crf_forward
from ..ops.matcher import match
from ..ops.poolers import multilevel_roi_pool
from ..ops.roi_align import roi_align, roi_pool
from ..ops.roi_pool import roi_pool_batched
from ..parallel import context
from ..structures import boxes as box_ops
from ..structures.batch import WSODBatch
from ..utils import tracing
from .heads import fast_rcnn as fast_rcnn_lib
from .heads import keypoint as keypoint_lib
from .heads import oicr as oicr_lib
from .heads import seg as seg_lib
from .heads import wsddn as wsddn_lib
from .heads.box_head import DiscriminativeAdaptionNeck
from .heads.cascade import match_and_label


def mask_targets(gt_masks: torch.Tensor, boxes: torch.Tensor,
                 midx: torch.Tensor, m: int) -> torch.Tensor:
    """Mask R-CNN's (B, S, m, m) float32 0/1 targets: each (B, S) box's
    matched (B, G, H, W) GT mask ``midx`` RoIAligned at m x m (sampling
    ratio 2, aligned) and thresholded at 0.5. An image's G masks are
    pooled as the channels of one float32 map and each box takes its
    match's channel: RoIAlign treats channels apart, so the values are
    those of pooling each box's own mask, without a (S, H, W) stack."""
    B, S = boxes.shape[:2]
    targets = []
    for i in range(B):
        maps = gt_masks[i].permute(1, 2, 0).float().contiguous()
        crops = roi_align(maps, boxes[i].detach(), 1.0, m, 2,
                          aligned=True)                      # (S, m, m, G)
        targets.append(torch.gather(
            crops, -1, midx[i][:, None, None, None].expand(S, m, m, 1)
        )[..., 0])
    return (torch.stack(targets) >= 0.5).float()


class GeneralizedRCNNWSL(nn.Module):
    """WSOD detector over precomputed proposals (static shapes throughout).

    Parameter names follow Detectron2's (``backbone.*``, ``box_head.fc1``,
    ``box_predictor.cls``, ``box_refinery.0.cls_score``,
    ``seg_head.aspp.conv1x1``; Fast R-CNN's ``box_predictor.cls_score``,
    Cascade's ``box_head.{k}.fc1`` and ``box_predictor.{k}.bbox_pred``,
    ``mask_head.mask_fcn1``, ``keypoint_head.score_lowres``).
    ``pyramid_strides`` ((level, stride), ...) pools from those levels of
    an FPN backbone. The mask head is built for Fast R-CNN and Cascade
    R-CNN where ``mask_on``, the keypoint head for Fast R-CNN where
    ``keypoint_on``; other heads ignore both flags in training, as the
    JAX package does."""

    def __init__(self, backbone: nn.Module, *, feature_name: str,
                 feature_stride: int, feature_channels: int,
                 num_classes: int, head_type: str, refine_k: int,
                 refine_reg: Sequence[bool], pooler_resolution: int,
                 dan_dims: Sequence[int], use_objectness: bool,
                 cls_agnostic_bbox_reg: bool, reg_weights: Sequence[float],
                 pixel_mean: Sequence[float], pixel_std: Sequence[float],
                 dtype: torch.dtype, dropout: float = 0.5,
                 mean_loss: bool = True, freeze_backbone: bool = True,
                 use_pallas_pooler: bool = True, with_seg: bool = False,
                 seg_constraint: bool = False,
                 pyramid_strides: Optional[Tuple[Tuple[str, int], ...]] = None,
                 pooler_type: str = "ROIPool",
                 pooler_sampling_ratio: int = 2,
                 cascade_ious: Sequence[float] = (0.5, 0.6, 0.7),
                 cascade_reg_weights: Sequence[Sequence[float]] = (
                     (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
                     (30.0, 30.0, 15.0, 15.0)),
                 mask_on: bool = False, mask_pooler_resolution: int = 14,
                 keypoint_on: bool = False, num_keypoints: int = 17,
                 keypoint_pooler_resolution: int = 14):
        super().__init__()
        self.mask_on, self.keypoint_on = mask_on, keypoint_on
        self.mask_pooler_resolution = mask_pooler_resolution
        self.num_keypoints = num_keypoints
        self.keypoint_pooler_resolution = keypoint_pooler_resolution
        self.backbone = backbone
        self.feature_name = feature_name
        self.feature_stride = feature_stride
        self.pyramid_strides = (None if pyramid_strides is None
                                else tuple(pyramid_strides))
        self.pooler_type = pooler_type
        self.pooler_sampling_ratio = max(pooler_sampling_ratio, 1)
        self.cascade_ious = tuple(cascade_ious)
        self.cascade_reg_weights = tuple(tuple(w) for w in cascade_reg_weights)
        self.head_type = head_type
        self.refine_k = refine_k
        self.refine_reg = tuple(refine_reg)
        self.pooler_resolution = pooler_resolution
        self.use_objectness = use_objectness
        self.reg_weights = tuple(reg_weights)
        self.num_classes = num_classes
        self.dtype = dtype
        self.mean_loss = mean_loss
        self.freeze_backbone = freeze_backbone
        self.use_pallas_pooler = use_pallas_pooler
        self.with_seg = with_seg
        self.seg_constraint = seg_constraint
        R = pooler_resolution
        self.dropout = dropout
        if head_type == "CascadeRCNN":
            # per stage: 2 FC of 1024 and a class-agnostic predictor
            self.box_head = nn.ModuleList([
                fast_rcnn_lib.FastRCNNConvFCHead(R * R * feature_channels,
                                                 (1024, 1024), dtype=dtype)
                for _ in self.cascade_ious])
            self.box_predictor = nn.ModuleList([
                fast_rcnn_lib.FastRCNNOutputLayers(1024, num_classes, True,
                                                   dtype=dtype)
                for _ in self.cascade_ious])
        else:
            self.box_head = DiscriminativeAdaptionNeck(
                R * R * feature_channels, dan_dims, dropout=dropout,
                dtype=dtype)
            self.box_predictor = (
                fast_rcnn_lib.FastRCNNOutputLayers(
                    dan_dims[-1], num_classes, cls_agnostic_bbox_reg,
                    dtype=dtype) if head_type == "FastRCNN"
                else wsddn_lib.WSDDNOutputLayers(dan_dims[-1], num_classes,
                                                 dtype=dtype))
        if head_type in ("OICR", "PCL") and refine_k > 0:
            self.box_refinery = nn.ModuleList([
                oicr_lib.RefinementOutputLayers(
                    dan_dims[-1], num_classes, cls_agnostic_bbox_reg,
                    dtype=dtype)
                for _ in range(refine_k)])
        if with_seg:
            self.seg_head = seg_lib.ASPPSegHead(feature_channels, num_classes,
                                                dtype=dtype)
        if mask_on and head_type in ("FastRCNN", "CascadeRCNN"):
            self.mask_head = seg_lib.MaskRCNNHead(feature_channels,
                                                  num_classes, dtype=dtype)
        if keypoint_on and head_type == "FastRCNN":
            self.keypoint_head = keypoint_lib.KRCNNConvDeconvUpsampleHead(
                feature_channels, num_keypoints, dtype=dtype)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std),
                             persistent=False)
        self._seen_shapes = set()   # (B, H, W) of every image batch run

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights: backbone convs N(0, 1/fan_in) and their
        biases 0 (FrozenBN stays the identity), the heads as the reference
        initialises them."""
        for m in self.backbone.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        heads = (list(self.box_head) + list(self.box_predictor)
                 if self.head_type == "CascadeRCNN"
                 else [self.box_head, self.box_predictor])
        for head in heads:
            head.init_weights(generator)
        for branch in getattr(self, "box_refinery", ()):
            branch.init_weights(generator)
        if self.with_seg:
            self.seg_head.init_weights(generator)
        for name in ("mask_head", "keypoint_head"):
            if hasattr(self, name):
                getattr(self, name).init_weights(generator)

    # ------------------------------------------------------------------ parts
    @staticmethod
    def sanitize(batch: WSODBatch) -> WSODBatch:
        """Zero the padded proposal slots with a select: their content is
        arbitrary, and multiplying by the mask would turn inf into NaN."""
        m = batch.proposal_mask
        return batch.replace(
            proposals=torch.where(m[..., None], batch.proposals, 0.0),
            objectness=torch.where(m, batch.objectness, 0.0))

    def preprocess(self, image: torch.Tensor) -> torch.Tensor:
        """Normalize raw pixels and cast to the compute dtype."""
        return ((image - self.pixel_mean) / self.pixel_std).to(self.dtype)

    def features(self, image: torch.Tensor):
        """(B, H, W, 3) raw pixels -> (B, Hf, Wf, C) contiguous map, or over
        an FPN {level: (B, Hl, Wl, C)} of the pooled levels, with no
        autograd history where the backbone is frozen.

        The NCHW view of an NHWC tensor is ``channels_last`` memory, which
        cuDNN prefers, and the NHWC view of the channels_last output is
        contiguous, as the pool kernel needs.

        A (B, H, W) this model has not run before adds one to the counter
        ``model.first_shape``: such a call is where cuDNN builds its
        plans."""
        shape = tuple(image.shape[:3])
        if shape not in self._seen_shapes:
            self._seen_shapes.add(shape)
            tracing.count("model.first_shape")
        with tracing.span("model.backbone"), \
                torch.set_grad_enabled(torch.is_grad_enabled()
                                       and not self.freeze_backbone):
            x = self.preprocess(image).permute(0, 3, 1, 2)
            out = self.backbone(x)
            if self.pyramid_strides is not None:
                return {n: out[n].permute(0, 2, 3, 1).contiguous()
                        for n, _ in self.pyramid_strides}
            return out[self.feature_name].permute(0, 2, 3, 1).contiguous()

    def pool_raw(self, feats, boxes: torch.Tensor,
                 resolution: Optional[int] = None) -> torch.Tensor:
        """(B, P, 4) boxes -> (B, P, R, R, C) in the map's dtype, unscaled,
        one image at a time, R ``resolution`` (the box head's by default):
        the multi-level pool over an FPN, else ``roi_pool`` (ROIPool) or
        ``roi_align`` (ROIAlign, ROIAlignV2)."""
        R = resolution or self.pooler_resolution
        if self.pyramid_strides is not None:
            strides = dict(self.pyramid_strides)
            names = [n for n, _ in self.pyramid_strides]
            return torch.stack([multilevel_roi_pool(
                {n: feats[n][i] for n in names}, strides, boxes[i], names,
                R, self.pooler_type, self.pooler_sampling_ratio)
                for i in range(boxes.shape[0])])
        scale = 1.0 / self.feature_stride
        if self.pooler_type == "ROIPool":
            return torch.stack([roi_pool(f, b, scale, R)
                                for f, b in zip(feats, boxes)])
        return torch.stack([
            roi_align(f, b, scale, R, self.pooler_sampling_ratio,
                      aligned=self.pooler_type == "ROIAlignV2")
            for f, b in zip(feats, boxes)])

    def pool(self, feats, proposals: torch.Tensor,
             prop_mask: torch.Tensor, objectness: torch.Tensor
             ) -> torch.Tensor:
        """RoI pool scaled by (objectness + 1) * mask:
        -> (B, P, R, R, C) in the map's dtype. K1 rounds the scale once,
        ``dtype(roi_scale)``; the differentiable pools multiply by
        ``dtype(objectness + 1)`` and then by ``dtype(mask)``, rounding
        after each, as the JAX package does (``meta_arch.py:241-244``)."""
        if self.use_pallas_pooler and self.pooler_type == "ROIPool" and \
                self.pyramid_strides is None:
            obj = (objectness + 1.0 if self.use_objectness
                   else torch.ones_like(objectness))
            roi_scale = obj * prop_mask.to(obj.dtype)
            return roi_pool_batched(feats, proposals.contiguous(),
                                    1.0 / self.feature_stride,
                                    self.pooler_resolution,
                                    roi_scale.contiguous())
        pooled = self.pool_raw(feats, proposals)
        if self.use_objectness:
            pooled = pooled * (objectness + 1.0)[..., None, None, None].to(
                pooled.dtype)
        return pooled * prop_mask[..., None, None, None].to(pooled.dtype)

    def pooled_features(self, feats, proposals, prop_mask, objectness,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """RoI pool + objectness scaling + DAN: -> (B, P, D). The DAN's
        dropout runs where a ``generator`` is given (training)."""
        with tracing.span("model.pool"):
            pooled = self.pool(feats, proposals, prop_mask, objectness)
        B, P = pooled.shape[:2]
        with tracing.span("model.box_head"):
            return self.box_head(pooled.reshape(B * P, -1),
                                 generator).reshape(B, P, -1)

    def proposal_scores(self, batch: WSODBatch) -> torch.Tensor:
        """WSDDN per-proposal scores (B, P, C) with dropout off: the
        quantity CSC takes image gradients of for its CPG maps."""
        batch = self.sanitize(batch)
        feats = self.features(batch.image)
        box_feats = self.pooled_features(
            feats, batch.proposals, batch.proposal_mask, batch.objectness)
        with tracing.span("model.predictor"):
            return self.box_predictor(box_feats, batch.proposal_mask)

    # ------------------------------------------------------------------ train
    def forward(self, batch: WSODBatch, *, train: bool = True,
                generator: Optional[torch.Generator] = None,
                csc_w: Optional[Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]] = None,
                cpg: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """Training losses: ``loss_cls`` (or, with ``csc_w`` = (W, PL, NL)
        from :func:`drn_wsod_torch.ops.csc.csc_forward`, the CSC-weighted
        ``loss_cls_pos`` and ``loss_cls_neg``), and per refinement branch
        ``loss_cls_r{k}`` (OICR or PCL) plus ``loss_box_reg_r{k}`` where an
        OICR branch regresses. ``train`` turns the DAN's dropout on, with
        masks drawn from ``generator``. With ``with_seg`` and ``train``:
        ``loss_seg`` where (B, C, H, W) CPG maps ``cpg`` are given, and
        ``loss_constraint`` under ``seg_constraint`` (the CRF against the
        raw image)."""
        if train and self.dropout > 0 and generator is None:
            raise ValueError("training with dropout needs a generator")
        batch = self.sanitize(batch)
        feats = self.features(batch.image)
        if self.head_type == "FastRCNN":
            return self.fast_rcnn_losses(feats, batch, generator, train)
        if self.head_type == "CascadeRCNN":
            return self.cascade_losses(feats, batch, generator)
        box_feats = self.pooled_features(
            feats, batch.proposals, batch.proposal_mask, batch.objectness,
            generator if train else None)

        with tracing.span("model.predictor"):
            scores = self.box_predictor(box_feats, batch.proposal_mask)
        if csc_w is not None:
            pos, neg = csc_lib.csc_loss(scores, *csc_w, self.mean_loss)
            losses = {"loss_cls_pos": pos, "loss_cls_neg": neg}
        else:
            losses = {"loss_cls": wsddn_lib.wsddn_loss(
                scores, batch.labels, self.mean_loss)}
        if self.with_seg and train:
            losses.update(self.seg_losses(feats, batch, cpg))
        if self.head_type == "WSDDN" or self.refine_k == 0:
            return losses

        img_evidence = wsddn_lib.image_probs(scores).detach()
        prev_scores = scores.detach()
        for k, branch in enumerate(self.box_refinery):
            with tracing.span("model.refine"):
                cls_logits, deltas = branch(box_feats)
                if self.head_type == "PCL":
                    # proposal-cluster targets; background in column 0
                    losses[f"loss_cls_r{k}"] = pcl_lib.pcl_branch_loss(
                        cls_logits, prev_scores, batch.proposals,
                        batch.proposal_mask, batch.labels)
                    prev_scores = oicr_lib.branch_probs(
                        cls_logits)[..., 1:].detach()
                    continue
                with tracing.span("model.refine.mine"):
                    pgt = oicr_lib.mine_pgt(prev_scores, batch.proposals,
                                            batch.proposal_mask,
                                            batch.labels, img_evidence)
                    targets = oicr_lib.label_proposals(
                        pgt, batch.proposals, batch.proposal_mask)
                with tracing.span("model.refine.loss"):
                    losses[f"loss_cls_r{k}"] = oicr_lib.refinement_loss(
                        cls_logits, targets)
                    if self.refine_reg[k]:
                        losses[f"loss_box_reg_r{k}"] = \
                            oicr_lib.refinement_box_loss(
                                deltas, batch.proposals, targets,
                                batch.proposal_mask, self.num_classes,
                                self.reg_weights)
                prev_scores = oicr_lib.branch_probs(
                    cls_logits)[..., :self.num_classes].detach()
        return losses

    def seg_losses(self, feats: torch.Tensor, batch: WSODBatch,
                   cpg: Optional[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The WSJDS branch's losses on the (B, Hf, Wf, C) feature map:
        ``loss_seg`` from detached CPG maps where given, and under the
        constraint ``loss_constraint``, its CRF targets from the raw image
        (``batch.image``, before normalisation)."""
        if cpg is None and not self.seg_constraint:
            return {}
        seg_logits = self.seg_head(feats)
        losses = {}
        if cpg is not None:
            losses["loss_seg"] = seg_lib.seg_loss_from_cpg(
                seg_logits, cpg.detach(), batch.labels)
        if self.seg_constraint:
            fg_probs = torch.sigmoid(seg_logits[..., 1:])
            crf_fg, w = seg_lib.crf_constraint(fg_probs, batch.image)
            losses["loss_constraint"] = seg_lib.crf_constraint_loss(
                fg_probs, crf_fg, w)
        return losses

    # ------------------------------------------------- supervised retraining
    def sample(self, batch: WSODBatch, generator: Optional[torch.Generator],
               iou_threshold: float = 0.5
               ) -> fast_rcnn_lib.SampledProposals:
        """Stage 0's slots: keys drawn from ``generator``, then
        ``subsample_proposals`` with its defaults (512 slots, a quarter
        foreground), as both JAX callers call it: ``ROI_HEADS.
        BATCH_SIZE_PER_IMAGE`` and ``POSITIVE_FRACTION`` are not read."""
        if generator is None:
            raise ValueError("the Fast R-CNN sampler needs a generator")
        fg_keys, bg_keys = fast_rcnn_lib.draw_sampling_keys(
            batch.proposal_mask.shape, generator, batch.proposals.device)
        return fast_rcnn_lib.subsample_proposals(
            batch.proposals, batch.proposal_mask, batch.gt_boxes,
            batch.gt_classes, batch.gt_valid, fg_keys, bg_keys,
            iou_thresholds=(iou_threshold,))

    def fast_rcnn_losses(self, feats, batch: WSODBatch,
                         generator: Optional[torch.Generator],
                         train: bool) -> Dict[str, torch.Tensor]:
        """Sample first, pool only the sampled boxes (scaled by their
        objectness, masked by their validity), DAN, ``box_predictor``;
        ``loss_cls`` and ``loss_box_reg``, each the mean over images."""
        sampled = self.sample(batch, generator)
        idx = sampled.indices
        boxes = batch.proposals.gather(1, idx[..., None].expand(-1, -1, 4))
        box_feats = self.pooled_features(
            feats, boxes, sampled.valid, batch.objectness.gather(1, idx),
            generator if train else None)
        cls_logits, deltas = self.box_predictor(box_feats)
        loss_cls, loss_box = fast_rcnn_lib.fast_rcnn_losses(
            cls_logits, deltas, batch.proposals, sampled, self.num_classes,
            self.reg_weights)
        losses = {"loss_cls": context.mean(loss_cls),
                  "loss_box_reg": context.mean(loss_box)}
        if self.keypoint_on and batch.gt_keypoints is not None:
            losses["loss_keypoint"] = self.keypoint_branch_loss(
                feats, boxes, sampled, batch)
        if self.mask_on and batch.gt_masks is not None:
            losses["loss_mask"] = self.mask_branch_loss(feats, boxes, sampled,
                                                        batch)
        return losses

    def pool_masked(self, feats, boxes: torch.Tensor, mask: torch.Tensor,
                    resolution: int) -> torch.Tensor:
        """``pool_raw`` at ``resolution`` times the (B, S) validity:
        (B, S, r, r, C)."""
        pooled = self.pool_raw(feats, boxes, resolution)
        return pooled * mask[..., None, None, None].to(pooled.dtype)

    @staticmethod
    def match_gt(batch: WSODBatch, boxes: torch.Tensor) -> torch.Tensor:
        """Each (B, S) box's best GT index at IoU 0.5 (0 without GT)."""
        return match(box_ops.pairwise_iou(batch.gt_boxes, boxes),
                     batch.gt_valid, [0.5], [0, 1])[0]

    def keypoint_branch_loss(self, feats, boxes: torch.Tensor,
                             sampled: fast_rcnn_lib.SampledProposals,
                             batch: WSODBatch) -> torch.Tensor:
        """Keypoint R-CNN's loss on the sampled (B, S) boxes: heatmaps of
        the boxes pooled at ``keypoint_pooler_resolution``, targets from
        each box's matched GT keypoints, counted on the valid foreground
        slots."""
        B, S = boxes.shape[:2]
        kr = self.keypoint_pooler_resolution
        pooled = self.pool_masked(feats, boxes, sampled.valid, kr)
        logits = self.keypoint_head(pooled.reshape(B * S, kr, kr, -1))
        hs = logits.shape[1]
        midx = self.match_gt(batch, boxes)
        K = batch.gt_keypoints.shape[2]
        kp = batch.gt_keypoints.gather(
            1, midx[..., None, None].expand(-1, -1, K, 3))
        tgt, valid = keypoint_lib.keypoints_to_heatmap_targets(kp, boxes, hs)
        fg = (sampled.gt_class >= 0) & sampled.valid
        valid = valid & fg[..., None]
        return keypoint_lib.keypoint_rcnn_loss(
            logits, tgt.reshape(B * S, -1), valid.reshape(B * S, -1))

    def mask_branch_loss(self, feats, boxes: torch.Tensor,
                         sampled: fast_rcnn_lib.SampledProposals,
                         batch: WSODBatch) -> torch.Tensor:
        """Mask R-CNN's loss on the sampled (B, S) boxes (module
        docstring): the GT masks of each image, as the channels of one
        float32 map, RoIAligned at every box, and each box's matched
        channel taken."""
        B, S = boxes.shape[:2]
        mr = self.mask_pooler_resolution
        pooled = self.pool_masked(feats, boxes, sampled.valid, mr)
        logits = self.mask_head(pooled.reshape(B * S, mr, mr, -1))
        m = logits.shape[1]
        targets = mask_targets(batch.gt_masks, boxes,
                               self.match_gt(batch, boxes), m)
        fg = (sampled.gt_class >= 0) & sampled.valid
        return seg_lib.mask_loss(logits, sampled.gt_class.reshape(B * S),
                                 targets.reshape(B * S, m, m),
                                 fg.reshape(B * S))

    def cascade_stage(self, k: int, feats, boxes: torch.Tensor,
                      mask: torch.Tensor):
        """Stage k on (B, S, 4) boxes: (cls_logits (B, S, C+1), deltas (B,
        S, 4), the detached regressed boxes for stage k+1). The pool is
        masked, not scaled by objectness."""
        B, S = boxes.shape[:2]
        pooled = self.pool_masked(feats, boxes, mask, self.pooler_resolution)
        h = self.box_head[k](pooled.reshape(B * S, -1))
        cls_logits, deltas = self.box_predictor[k](h)
        cls_logits, deltas = cls_logits.reshape(B, S, -1), deltas.reshape(
            B, S, 4)
        new_boxes = box_ops.apply_deltas(deltas.detach(), boxes,
                                         self.cascade_reg_weights[k])
        return cls_logits, deltas, new_boxes

    def cascade_losses(self, feats, batch: WSODBatch,
                       generator: Optional[torch.Generator]
                       ) -> Dict[str, torch.Tensor]:
        """Stage 0 samples once at the first IoU; stage k > 0 matches the
        clipped boxes of stage k-1 at its own IoU, on the same slots.
        ``loss_cls_stage{k}`` and ``loss_box_reg_stage{k}``, and with the
        mask head ``loss_mask`` on stage 0's sample."""
        sampled = self.sample(batch, generator, self.cascade_ious[0])
        boxes = batch.proposals.gather(
            1, sampled.indices[..., None].expand(-1, -1, 4))
        boxes0 = boxes
        valid = sampled.valid
        slots = torch.arange(boxes.shape[1], device=boxes.device).expand(
            boxes.shape[0], -1)
        hw = batch.image_hw[:, None, :]
        losses = {}
        for k, iou in enumerate(self.cascade_ious):
            if k == 0:
                cls_tgt, box_tgt = sampled.gt_class, sampled.gt_box
            else:
                cls_tgt, box_tgt = match_and_label(
                    boxes, batch.gt_boxes, batch.gt_classes, batch.gt_valid,
                    iou)
            cls_logits, deltas, new_boxes = self.cascade_stage(
                k, feats, boxes, valid)
            loss_cls, loss_box = fast_rcnn_lib.fast_rcnn_losses(
                cls_logits, deltas, boxes, fast_rcnn_lib.SampledProposals(
                    slots, cls_tgt, box_tgt, valid),
                self.num_classes, self.cascade_reg_weights[k])
            losses[f"loss_cls_stage{k}"] = context.mean(loss_cls)
            losses[f"loss_box_reg_stage{k}"] = context.mean(loss_box)
            boxes = box_ops.clip(new_boxes, hw)
        if self.mask_on and batch.gt_masks is not None:
            losses["loss_mask"] = self.mask_branch_loss(feats, boxes0, sampled,
                                                        batch)
        return losses

    # -------------------------------------------------------------- inference
    @torch.inference_mode()
    def semantic_logits(self, batch: WSODBatch) -> torch.Tensor:
        """(B, Hf, Wf, C+1) semantic logits of the WSJDS branch. Under the
        constraint, the dense CRF refines the class probabilities at the
        head's own resolution against the raw image resized to it, and the
        log of the refined probabilities (clipped at 1e-8) is returned."""
        if not self.with_seg:
            raise ValueError("semantic_logits needs the WSJDS seg head")
        logits = self.seg_head(self.features(batch.image))
        if self.seg_constraint:
            _, h, w, _ = logits.shape
            img_small = seg_lib.resize_images(batch.image, h, w)
            refined = crf_forward(torch.softmax(logits, -1), img_small)
            logits = torch.log(refined.clamp(min=1e-8))
        return logits

    @torch.inference_mode()
    def predict_masks(self, feats, boxes: torch.Tensor,
                      classes: torch.Tensor) -> torch.Tensor:
        """Mask probabilities of each (B, D) box's class, from ``feats``
        (``features`` of the batch) and boxes in the resized frame:
        (B, D, 2r, 2r) float32 sigmoids."""
        if not hasattr(self, "mask_head"):
            raise ValueError(f"predict_masks needs the mask head, which the "
                             f"{self.head_type} head does not build")
        mr = self.mask_pooler_resolution
        B, D = boxes.shape[:2]
        pooled = self.pool_raw(feats, boxes, mr)
        logits = self.mask_head(pooled.reshape(B * D, mr, mr, -1))
        m = logits.shape[1]
        logits = logits.reshape(B, D, m, m, -1)
        cls = classes.long().clamp(0, self.num_classes - 1)
        sel = torch.gather(logits, -1,
                           cls[:, :, None, None, None].expand(B, D, m, m, 1))
        return torch.sigmoid(sel[..., 0])

    @torch.inference_mode()
    def predict_keypoints(self, feats, boxes: torch.Tensor) -> torch.Tensor:
        """Decoded keypoints of (B, D) boxes in the resized frame, from
        ``feats``: (B, D, K, 3) as (x, y, score)."""
        if not hasattr(self, "keypoint_head"):
            raise ValueError(f"predict_keypoints needs the keypoint head, "
                             f"which the {self.head_type} head does not "
                             "build")
        kr = self.keypoint_pooler_resolution
        B, D = boxes.shape[:2]
        pooled = self.pool_raw(feats, boxes, kr)
        logits = self.keypoint_head(pooled.reshape(B * D, kr, kr, -1))
        kps = keypoint_lib.heatmaps_to_keypoints(logits, boxes.reshape(-1, 4))
        return kps.reshape(B, D, self.num_keypoints, 3)

    @torch.inference_mode()
    def inference_scores(self, batch: WSODBatch, feats=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full score/box matrices for NMS, from ``feats`` where the caller
        computed ``features(batch.image)`` already, on a batch it passed
        through ``sanitize`` first.

        Returns:
          scores: (B, P, C+1) float32, last column background (zeros for
            WSDDN), padded rows zero; Cascade R-CNN's the mean of its
            stages' softmax.
          boxes: (B, P, 4) class-agnostic, or (B, P, C*4) when the last
            refinement branch regresses boxes; Fast R-CNN's the decoded
            deltas (4 or C*4), Cascade's the last stage's clipped boxes.
        """
        if feats is None:
            batch = self.sanitize(batch)
            feats = self.features(batch.image)
        mask = batch.proposal_mask[..., None]
        if self.head_type == "CascadeRCNN":
            # the stages' softmax averaged, the last stage's boxes
            boxes, probs = batch.proposals, []
            hw = batch.image_hw[:, None, :]
            for k in range(len(self.cascade_ious)):
                cls_logits, _, new_boxes = self.cascade_stage(
                    k, feats, boxes, batch.proposal_mask)
                probs.append(torch.softmax(cls_logits, -1))
                boxes = box_ops.clip(new_boxes, hw)
            return torch.where(mask, sum(probs) / len(probs), 0.0), boxes
        box_feats = self.pooled_features(feats, batch.proposals,
                                         batch.proposal_mask, batch.objectness)
        if self.head_type == "FastRCNN":
            cls_logits, deltas = self.box_predictor(box_feats)
            boxes = box_ops.apply_deltas(deltas, batch.proposals,
                                         self.reg_weights)
            return torch.where(mask, torch.softmax(cls_logits, -1), 0.0), boxes

        if self.head_type == "WSDDN" or self.refine_k == 0:
            with tracing.span("model.predictor"):
                scores = self.box_predictor(box_feats, batch.proposal_mask)
            scores = torch.where(mask, scores, 0.0)
            return wsddn_lib.append_background(scores), batch.proposals

        with tracing.span("model.refine"):
            logits, deltas = zip(*(branch(box_feats)
                                   for branch in self.box_refinery))
        if self.refine_reg[-1]:
            scores = oicr_lib.branch_probs(logits[-1])
            boxes = box_ops.apply_deltas(deltas[-1], batch.proposals,
                                         self.reg_weights)
        else:
            scores = oicr_lib.average_branch_probs(logits)
            boxes = batch.proposals
        if self.head_type == "PCL":
            # PCL trains with background in column 0: rotate it to the back
            scores = torch.cat([scores[..., 1:], scores[..., :1]], -1)
        return torch.where(mask, scores, 0.0), boxes
