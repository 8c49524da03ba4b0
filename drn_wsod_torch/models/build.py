"""Model builder (counterpart of ``drn_wsod_tpu/models/build.py``).

The port builds the WSOD meta-architecture over the WS-ResNet, the plain
ResNet or VGG-16, named by ``MODEL.BACKBONE.NAME`` in a registry as in the
JAX package, with the WSDDN, OICR, PCL, CSC, CSC + OICR or WSJDS (CSC with
the segmentation branch) head, its backbone frozen or trainable from
``FREEZE_AT``. Every other configuration the JAX package supports raises
``NotImplementedError`` naming the ROADMAP.md queue-1 item that ports it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import CfgNode
from ..device import resolve_device
from ..solver.build import make_param_labels
from .backbones import (build_resnet_backbone, build_vgg_backbone,
                        build_ws_resnet_backbone)
from .backbones.resnet_ws import model_dtype
from .meta_arch import GeneralizedRCNNWSL

# MODEL.BACKBONE.NAME -> builder (the JAX package's BACKBONE_REGISTRY)
BACKBONES = {"build_ws_resnet_backbone": build_ws_resnet_backbone,
             "build_resnet_backbone": build_resnet_backbone,
             "build_vgg_backbone": build_vgg_backbone}

_HEAD_TYPES = {"WSDDNROIHeads": "WSDDN", "OICRROIHeads": "OICR",
               "PCLROIHeads": "PCL", "CSCROIHeads": "CSC",
               # CSC's weighted image loss with OICR's refinement branches
               "CSCOICRROIHeads": "OICR",
               # CSC with the semantic segmentation branch
               "WSJDSROIHeads": "CSC"}

# heads whose train step takes CPG maps by gradients to the image: the
# trainer switches to the CSC step for them, and their pool must carry
# gradients (K1 is forward-only)
CSC_HEAD_NAMES = frozenset({"CSCROIHeads", "CSCOICRROIHeads",
                            "WSJDSROIHeads"})

_NOT_YET = {
    "StandardROIHeads": "item 14 (supervised and pyramid paths)",
    "Res5ROIHeads": "item 14 (supervised and pyramid paths)",
    "CascadeROIHeads": "item 14 (supervised and pyramid paths)",
    "build_resnet_fpn_backbone": "item 14 (supervised and pyramid paths)",
    "RetinaNet": "item 15 (remaining models)",
    "PanopticFPN": "item 15 (remaining models)",
    "SemanticSegmentor": "item 15 (remaining models)",
}


def _not_ported(what: str, name: str):
    return NotImplementedError(
        f"{what} {name!r} is not ported yet: ROADMAP.md queue 1, "
        f"{_NOT_YET.get(name, 'a later slice')}")


def _build_rcnn_wsl(cfg: CfgNode) -> GeneralizedRCNNWSL:
    if cfg.MODEL.BACKBONE.NAME not in BACKBONES:
        raise _not_ported("backbone", cfg.MODEL.BACKBONE.NAME)
    head_name = cfg.MODEL.ROI_HEADS.NAME
    if head_name not in _HEAD_TYPES:
        raise _not_ported("ROI head", head_name)
    box = cfg.MODEL.ROI_BOX_HEAD
    if box.POOLER_TYPE != "ROIPool":
        raise NotImplementedError(
            f"POOLER_TYPE {box.POOLER_TYPE!r} is not ported yet: ROADMAP.md "
            "queue 1, item 14 (supervised and pyramid paths)")
    if len(cfg.MODEL.ROI_HEADS.IN_FEATURES) != 1:
        raise NotImplementedError(
            "multi-level pooling is not ported yet: ROADMAP.md queue 1, "
            "item 14 (supervised and pyramid paths)")
    if cfg.MODEL.MASK_ON or cfg.MODEL.KEYPOINT_ON:
        raise NotImplementedError(
            "mask and keypoint branches are not ported yet: ROADMAP.md "
            "queue 1, item 14 (supervised and pyramid paths)")

    backbone = BACKBONES[cfg.MODEL.BACKBONE.NAME](cfg)
    feature_name = cfg.MODEL.ROI_HEADS.IN_FEATURES[0]
    head_type = _HEAD_TYPES[head_name]
    refine_k = cfg.WSL.REFINE_NUM if head_type in ("OICR", "PCL") else 0
    refine_reg = tuple(cfg.WSL.REFINE_REG)
    refine_reg = (refine_reg + (False,) * refine_k)[:refine_k]
    return GeneralizedRCNNWSL(
        backbone,
        feature_name=feature_name,
        feature_stride=backbone.feature_strides[feature_name],
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
    )


def build_model(cfg: CfgNode, device=None,
                generator: Optional[torch.Generator] = None
                ) -> GeneralizedRCNNWSL:
    """Build the configured model on ``device`` (CUDA unless the caller
    names another device; raises where CUDA is absent).

    Weights are drawn from ``generator`` (default: a generator on the device
    seeded with 0); load real ones with ``load_state_dict``. The conv
    weights of the frozen backbone stages (below ``FREEZE_AT``: all of them
    at 5) are stored in ``MODEL.DTYPE`` and take no gradient; FrozenBN
    statistics stay float32. The heads' parameters and the trainable
    stages' conv weights stay float32 masters, cast to ``MODEL.DTYPE`` at
    each use (flax's ``param_dtype`` float32 with ``dtype`` bfloat16), so
    that SGD updates below bfloat16's resolution are kept. BatchNorm's
    affine and statistics (``NORM`` BN) stay float32 and take no gradient.
    """
    dev = resolve_device(device)
    arch = cfg.MODEL.META_ARCHITECTURE
    if arch != "GeneralizedRCNNWSL":
        raise _not_ported("meta-architecture", arch)
    with torch.device(dev):
        model = _build_rcnn_wsl(cfg)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model.init_weights(generator)
    labels = make_param_labels(
        [n for n, _ in model.named_parameters()], cfg.MODEL.BACKBONE.FREEZE_AT)
    for name, p in model.backbone.named_parameters():
        if model.freeze_backbone or labels[f"backbone.{name}"] == "frozen":
            if not name.endswith((".norm.weight", ".norm.bias")):
                p.data = p.data.to(model.dtype)
            p.requires_grad_(False)
    model.backbone.to(memory_format=torch.channels_last)
    return model.eval()
