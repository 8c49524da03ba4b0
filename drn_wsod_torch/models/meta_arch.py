"""GeneralizedRCNNWSL, the WSOD meta-architecture (counterpart of
``drn_wsod_tpu/models/meta_arch.py``).

Backbone over raw NHWC pixels, exact RoIPool over padded proposals with the
``(objectness + 1) * mask`` scale fused into the pool's epilogue, the DAN
neck, then the WSDDN head or the OICR refinement branches. ``forward``
returns the training losses of the WSDDN and OICR arms; ``inference_scores``
the score and box matrices that feed NMS. The CSC, PCL, segmentation,
Fast R-CNN and Cascade arms are later slices (ROADMAP.md queue 1, items 13
and 14).

The frozen backbone runs without autograd (the counterpart of
``stop_gradient``), and the pool kernel is forward-only, as in the JAX
package: gradients start at the DAN.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.roi_pool import roi_pool_batched
from ..structures import boxes as box_ops
from ..structures.batch import WSODBatch
from .heads import oicr as oicr_lib
from .heads import wsddn as wsddn_lib
from .heads.box_head import DiscriminativeAdaptionNeck


class GeneralizedRCNNWSL(nn.Module):
    """WSOD detector over precomputed proposals (static shapes throughout).

    Parameter names follow Detectron2's (``backbone.*``, ``box_head.fc1``,
    ``box_predictor.cls``, ``box_refinery.0.cls_score``)."""

    def __init__(self, backbone: nn.Module, *, feature_name: str,
                 feature_stride: int, feature_channels: int,
                 num_classes: int, head_type: str, refine_k: int,
                 refine_reg: Sequence[bool], pooler_resolution: int,
                 dan_dims: Sequence[int], use_objectness: bool,
                 cls_agnostic_bbox_reg: bool, reg_weights: Sequence[float],
                 pixel_mean: Sequence[float], pixel_std: Sequence[float],
                 dtype: torch.dtype, dropout: float = 0.5,
                 mean_loss: bool = True, freeze_backbone: bool = True):
        super().__init__()
        self.backbone = backbone
        self.feature_name = feature_name
        self.feature_stride = feature_stride
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
        R = pooler_resolution
        self.box_head = DiscriminativeAdaptionNeck(
            R * R * feature_channels, dan_dims, dropout=dropout, dtype=dtype)
        self.box_predictor = wsddn_lib.WSDDNOutputLayers(
            dan_dims[-1], num_classes, dtype=dtype)
        if head_type == "OICR" and refine_k > 0:
            self.box_refinery = nn.ModuleList([
                oicr_lib.RefinementOutputLayers(
                    dan_dims[-1], num_classes, cls_agnostic_bbox_reg,
                    dtype=dtype)
                for _ in range(refine_k)])
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std),
                             persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights: backbone convs N(0, 1/fan_in) (FrozenBN
        stays the identity), the heads as the reference initialises them."""
        for m in self.backbone.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        self.box_head.init_weights(generator)
        self.box_predictor.init_weights(generator)
        for branch in getattr(self, "box_refinery", ()):
            branch.init_weights(generator)

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

    def features(self, image: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) raw pixels -> (B, Hf, Wf, C) contiguous map.

        The NCHW view of an NHWC tensor is ``channels_last`` memory, which
        cuDNN prefers, and the NHWC view of the channels_last output is
        contiguous, as the pool kernel needs."""
        x = self.preprocess(image).permute(0, 3, 1, 2)
        out = self.backbone(x)[self.feature_name]
        return out.permute(0, 2, 3, 1).contiguous()

    def pool(self, feats: torch.Tensor, proposals: torch.Tensor,
             prop_mask: torch.Tensor, objectness: torch.Tensor
             ) -> torch.Tensor:
        """Exact RoIPool scaled by (objectness + 1) * mask:
        -> (B, P, R, R, C) in the map's dtype."""
        obj = (objectness + 1.0 if self.use_objectness
               else torch.ones_like(objectness))
        roi_scale = obj * prop_mask.to(obj.dtype)
        return roi_pool_batched(feats, proposals.contiguous(),
                                1.0 / self.feature_stride,
                                self.pooler_resolution, roi_scale.contiguous())

    def pooled_features(self, feats, proposals, prop_mask, objectness,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
        """RoI pool + objectness scaling + DAN: -> (B, P, D). The DAN's
        dropout runs where a ``generator`` is given (training)."""
        pooled = self.pool(feats, proposals, prop_mask, objectness)
        B, P = pooled.shape[:2]
        return self.box_head(pooled.reshape(B * P, -1),
                             generator).reshape(B, P, -1)

    # ------------------------------------------------------------------ train
    def forward(self, batch: WSODBatch, *, train: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """Training losses of the WSDDN or OICR arm: ``loss_cls``, and per
        refinement branch ``loss_cls_r{k}`` plus ``loss_box_reg_r{k}`` where
        ``refine_reg[k]``. ``train`` turns the DAN's dropout on, with masks
        drawn from ``generator``."""
        if train and self.box_head.dropout > 0 and generator is None:
            raise ValueError("training with dropout needs a generator")
        batch = self.sanitize(batch)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_backbone):
            feats = self.features(batch.image)
        box_feats = self.pooled_features(
            feats, batch.proposals, batch.proposal_mask, batch.objectness,
            generator if train else None)

        scores = self.box_predictor(box_feats, batch.proposal_mask)
        losses = {"loss_cls": wsddn_lib.wsddn_loss(scores, batch.labels,
                                                   self.mean_loss)}
        if self.head_type == "WSDDN" or self.refine_k == 0:
            return losses

        img_evidence = wsddn_lib.image_probs(scores).detach()
        prev_scores = scores.detach()
        for k, branch in enumerate(self.box_refinery):
            cls_logits, deltas = branch(box_feats)
            pgt = oicr_lib.mine_pgt(prev_scores, batch.proposals,
                                    batch.proposal_mask, batch.labels,
                                    img_evidence)
            targets = oicr_lib.label_proposals(pgt, batch.proposals,
                                               batch.proposal_mask)
            losses[f"loss_cls_r{k}"] = oicr_lib.refinement_loss(cls_logits,
                                                                targets)
            if self.refine_reg[k]:
                losses[f"loss_box_reg_r{k}"] = oicr_lib.refinement_box_loss(
                    deltas, batch.proposals, targets, batch.proposal_mask,
                    self.num_classes, self.reg_weights)
            prev_scores = oicr_lib.branch_probs(
                cls_logits)[..., :self.num_classes].detach()
        return losses

    # -------------------------------------------------------------- inference
    @torch.inference_mode()
    def inference_scores(self, batch: WSODBatch
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full score/box matrices for NMS.

        Returns:
          scores: (B, P, C+1) float32, last column background (zeros for
            WSDDN), padded rows zero.
          boxes: (B, P, 4) class-agnostic, or (B, P, C*4) when the last
            refinement branch regresses boxes.
        """
        batch = self.sanitize(batch)
        feats = self.features(batch.image)
        box_feats = self.pooled_features(feats, batch.proposals,
                                         batch.proposal_mask, batch.objectness)
        mask = batch.proposal_mask[..., None]

        if self.head_type == "WSDDN" or self.refine_k == 0:
            scores = self.box_predictor(box_feats, batch.proposal_mask)
            scores = torch.where(mask, scores, 0.0)
            return wsddn_lib.append_background(scores), batch.proposals

        logits, deltas = zip(*(branch(box_feats)
                               for branch in self.box_refinery))
        if self.refine_reg[-1]:
            scores = oicr_lib.branch_probs(logits[-1])
            boxes = box_ops.apply_deltas(deltas[-1], batch.proposals,
                                         self.reg_weights)
        else:
            scores = oicr_lib.average_branch_probs(logits)
            boxes = batch.proposals
        return torch.where(mask, scores, 0.0), boxes
