"""Model builder (counterpart of ``drn_wsod_tpu/models/build.py``).

The port builds the WSOD meta-architecture over the WS-ResNet (deformable
and grouped blocks included), the plain ResNet, VGG-16 or the FPN over the
WS-ResNet, named by ``MODEL.BACKBONE.NAME`` in a registry as in the JAX
package, with the WSDDN, OICR, PCL, CSC, CSC + OICR or WSJDS (CSC with the
segmentation branch) head, or the supervised Fast R-CNN or Cascade R-CNN
head, pooling by ROIPool, ROIAlign or ROIAlignV2 from one level or from the
FPN's, its backbone frozen or trainable from ``FREEZE_AT``; ``MASK_ON``
adds the Mask R-CNN head to Fast R-CNN and Cascade R-CNN, ``KEYPOINT_ON``
the Keypoint R-CNN head to Fast R-CNN (the other heads ignore both, as in
the JAX package). ``MODEL.META_ARCHITECTURE`` also names the dense models
over the FPN: ``RetinaNet``, ``SemanticSegmentor`` and ``PanopticFPN``.
A backbone or ROI head the port lacks raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import CfgNode
from ..device import resolve_device
from ..solver.build import make_param_labels
from .backbones import (build_resnet_backbone, build_resnet_fpn_backbone,
                        build_vgg_backbone, build_ws_resnet_backbone)
from .backbones.resnet_ws import model_dtype
from .meta_arch import GeneralizedRCNNWSL
from .panoptic import PanopticFPN
from .retinanet import RetinaNet
from .semantic_seg import SemanticSegmentor

# MODEL.BACKBONE.NAME -> builder (the JAX package's BACKBONE_REGISTRY)
BACKBONES = {"build_ws_resnet_backbone": build_ws_resnet_backbone,
             "build_resnet_backbone": build_resnet_backbone,
             "build_vgg_backbone": build_vgg_backbone,
             "build_resnet_fpn_backbone": build_resnet_fpn_backbone}

_HEAD_TYPES = {"WSDDNROIHeads": "WSDDN", "OICRROIHeads": "OICR",
               "PCLROIHeads": "PCL", "CSCROIHeads": "CSC",
               # CSC's weighted image loss with OICR's refinement branches
               "CSCOICRROIHeads": "OICR",
               # CSC with the semantic segmentation branch
               "WSJDSROIHeads": "CSC",
               # the supervised heads of pseudo-GT retraining: both
               # Detectron2 names take the one Fast R-CNN path
               "StandardROIHeads": "FastRCNN", "Res5ROIHeads": "FastRCNN",
               "CascadeROIHeads": "CascadeRCNN"}

# heads whose train step takes CPG maps by gradients to the image: the
# trainer switches to the CSC step for them, and their pool must carry
# gradients (K1 is forward-only)
CSC_HEAD_NAMES = frozenset({"CSCROIHeads", "CSCOICRROIHeads",
                            "WSJDSROIHeads"})

def _not_ported(what: str, name: str):
    return NotImplementedError(f"{what} {name!r} is not ported: the JAX "
                               "package has no such component either")


def _backbone(cfg: CfgNode):
    if cfg.MODEL.BACKBONE.NAME not in BACKBONES:
        raise _not_ported("backbone", cfg.MODEL.BACKBONE.NAME)
    return BACKBONES[cfg.MODEL.BACKBONE.NAME](cfg)


def _build_rcnn_wsl(cfg: CfgNode) -> GeneralizedRCNNWSL:
    head_name = cfg.MODEL.ROI_HEADS.NAME
    if head_name not in _HEAD_TYPES:
        raise _not_ported("ROI head", head_name)
    box = cfg.MODEL.ROI_BOX_HEAD
    if box.POOLER_TYPE not in ("ROIPool", "ROIAlign", "ROIAlignV2"):
        raise ValueError(f"Unknown POOLER_TYPE {box.POOLER_TYPE!r}")
    backbone = _backbone(cfg)
    in_features = list(cfg.MODEL.ROI_HEADS.IN_FEATURES)
    feature_name = in_features[0]
    strides = backbone.feature_strides
    head_type = _HEAD_TYPES[head_name]
    refine_k = cfg.WSL.REFINE_NUM if head_type in ("OICR", "PCL") else 0
    refine_reg = tuple(cfg.WSL.REFINE_REG)
    refine_reg = (refine_reg + (False,) * refine_k)[:refine_k]
    cascade = cfg.MODEL.ROI_BOX_CASCADE_HEAD
    return GeneralizedRCNNWSL(
        backbone,
        feature_name=feature_name,
        pyramid_strides=(tuple((f, strides[f]) for f in in_features)
                         if len(in_features) > 1 else None),
        pooler_type=box.POOLER_TYPE,
        pooler_sampling_ratio=box.POOLER_SAMPLING_RATIO or 2,
        cascade_ious=tuple(cascade.IOUS),
        cascade_reg_weights=tuple(tuple(w)
                                  for w in cascade.BBOX_REG_WEIGHTS),
        feature_stride=strides[feature_name],
        feature_channels=backbone.feature_channels[feature_name],
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
        head_type=head_type,
        refine_k=refine_k,
        refine_reg=refine_reg,
        pooler_resolution=box.POOLER_RESOLUTION,
        dan_dims=tuple(box.DAN_DIM),
        use_objectness=cfg.WSL.USE_OBN,
        cls_agnostic_bbox_reg=box.CLS_AGNOSTIC_BBOX_REG,
        reg_weights=tuple(box.BBOX_REG_WEIGHTS),
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        dtype=model_dtype(cfg),
        dropout=box.DROPOUT,
        mean_loss=cfg.WSL.MEAN_LOSS,
        freeze_backbone=cfg.MODEL.BACKBONE.FREEZE_AT >= 5,
        with_seg=head_name == "WSJDSROIHeads",
        seg_constraint=(head_name == "WSJDSROIHeads"
                        and cfg.MODEL.SEM_SEG_HEAD.CONSTRAINT),
        # K1 is forward-only: CSC's image gradients and a trainable
        # backbone's feature gradients take the differentiable pool
        use_pallas_pooler=(box.USE_PALLAS_POOLER
                           and head_name not in CSC_HEAD_NAMES
                           and cfg.MODEL.BACKBONE.FREEZE_AT >= 5),
        mask_on=cfg.MODEL.MASK_ON,
        mask_pooler_resolution=cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION,
        keypoint_on=cfg.MODEL.KEYPOINT_ON,
        num_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS,
        keypoint_pooler_resolution=(
            cfg.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION),
    )


def _build_retinanet(cfg: CfgNode) -> RetinaNet:
    backbone = _backbone(cfg)
    r = cfg.MODEL.RETINANET
    in_features = tuple(r.IN_FEATURES)
    sizes = tuple(tuple(float(x) for x in s)
                  for s in cfg.MODEL.ANCHOR_GENERATOR.SIZES)
    if len(sizes) != len(in_features):
        raise AssertionError("ANCHOR_GENERATOR.SIZES must list one size "
                             "group per IN_FEATURE")
    return RetinaNet(
        backbone, in_features=in_features,
        strides=tuple(int(backbone.feature_strides[f]) for f in in_features),
        anchor_sizes=sizes,
        aspect_ratios=tuple(
            float(a) for a in cfg.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS[0]),
        num_classes=r.NUM_CLASSES, num_convs=r.NUM_CONVS,
        prior_prob=r.PRIOR_PROB, iou_thresholds=tuple(r.IOU_THRESHOLDS),
        iou_labels=tuple(r.IOU_LABELS), focal_alpha=r.FOCAL_LOSS_ALPHA,
        focal_gamma=r.FOCAL_LOSS_GAMMA,
        smooth_l1_beta=r.SMOOTH_L1_LOSS_BETA,
        reg_weights=tuple(r.BBOX_REG_WEIGHTS),
        topk_candidates=r.TOPK_CANDIDATES_TEST,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD), dtype=model_dtype(cfg))


def _build_panoptic_fpn(cfg: CfgNode) -> PanopticFPN:
    backbone = _backbone(cfg)
    strides = backbone.feature_strides
    sem = cfg.MODEL.SEM_SEG_HEAD
    sem_feats = tuple(sem.IN_FEATURES)
    box_feats = tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES) or sem_feats
    return PanopticFPN(
        backbone, pyramid_strides=tuple((f, int(strides[f]))
                                        for f in box_feats),
        sem_in_features=sem_feats,
        sem_strides=tuple(int(strides[f]) for f in sem_feats),
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
        sem_num_classes=sem.NUM_CLASSES, common_stride=sem.COMMON_STRIDE,
        sem_conv_dim=sem.CONVS_DIM,
        pooler_resolution=cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION,
        mask_on=cfg.MODEL.MASK_ON,
        instance_loss_weight=cfg.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT,
        sem_loss_weight=sem.LOSS_WEIGHT,
        reg_weights=tuple(cfg.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS),
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD), dtype=model_dtype(cfg))


def _build_semantic_segmentor(cfg: CfgNode) -> SemanticSegmentor:
    backbone = _backbone(cfg)
    sem = cfg.MODEL.SEM_SEG_HEAD
    sem_feats = tuple(sem.IN_FEATURES)
    return SemanticSegmentor(
        backbone, sem_in_features=sem_feats,
        sem_strides=tuple(int(backbone.feature_strides[f])
                          for f in sem_feats),
        num_classes=sem.NUM_CLASSES, common_stride=sem.COMMON_STRIDE,
        conv_dim=sem.CONVS_DIM, loss_weight=sem.LOSS_WEIGHT,
        ignore_value=sem.IGNORE_VALUE,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD), dtype=model_dtype(cfg))


# MODEL.META_ARCHITECTURE -> builder (the JAX package's META_ARCH_REGISTRY)
META_ARCHS = {"GeneralizedRCNNWSL": _build_rcnn_wsl,
              "RetinaNet": _build_retinanet,
              "PanopticFPN": _build_panoptic_fpn,
              "SemanticSegmentor": _build_semantic_segmentor}


def build_model(cfg: CfgNode, device=None,
                generator: Optional[torch.Generator] = None
                ) -> torch.nn.Module:
    """Build the configured model on ``device`` (CUDA unless the caller
    names another device; raises where CUDA is absent).

    Weights are drawn from ``generator`` (default: a generator on the device
    seeded with 0); load real ones with ``load_state_dict``. The parameters
    the optimizer labels frozen (``solver/build.py:make_param_labels``: the
    backbone stages below ``FREEZE_AT``, all of them at 5) are stored in
    ``MODEL.DTYPE`` and take no gradient; FrozenBN statistics stay float32,
    and so do the deformable blocks' ``conv2_offset``, which computes in
    float32. Every other parameter stays a float32 master, cast to
    ``MODEL.DTYPE`` at each use (flax's ``param_dtype`` float32 with
    ``dtype`` bfloat16), so that SGD updates below bfloat16's resolution
    are kept. Under an FPN that is the whole backbone but the norms, as in
    the JAX package, whose labels freeze only the stem and ``res{k}``
    modules directly under ``backbone``: at ``FREEZE_AT`` 5 those weights
    take zero gradients (the features run without autograd) and move by
    weight decay and momentum alone. BatchNorm's affine and statistics
    (``NORM`` BN) stay float32 and take no gradient.
    """
    dev = resolve_device(device)
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch not in META_ARCHS:
        raise KeyError(f"{arch} not found in META_ARCH registry; "
                       f"available: {sorted(META_ARCHS)}")
    with torch.device(dev):
        model = META_ARCHS[arch](cfg)
    if dev.type != "meta":      # the meta device holds no values to draw
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        model.init_weights(generator)
    labels = make_param_labels(
        [n for n, _ in model.named_parameters()], cfg.MODEL.BACKBONE.FREEZE_AT)
    for name, p in model.backbone.named_parameters():
        if labels[f"backbone.{name}"] == "frozen":
            if not name.endswith((".norm.weight", ".norm.bias")) and \
                    ".conv2_offset." not in name:
                p.data = p.data.to(model.dtype)
            p.requires_grad_(False)
    model.backbone.to(memory_format=torch.channels_last)
    return model.eval()
