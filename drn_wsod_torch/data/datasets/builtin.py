"""Register the builtin datasets under one root: what the JAX package's
``tools/train_net.py:main`` registers. Cityscapes is not among them, as
it is not there: ``cityscapes.register_all_cityscapes`` registers it."""

from __future__ import annotations

from .builtin_web import register_all_voc_sbd, register_all_web
from .coco import register_all_coco
from .lvis import register_all_lvis
from .voc import register_all_pascal_voc


def register_all(root: str = "datasets") -> None:
    """VOC, COCO (its panoptic-separated splits too), LVIS v1, and the
    web and VOC-SBD sets whose json exists."""
    register_all_pascal_voc(root)
    register_all_coco(root)
    register_all_lvis(root)
    register_all_web(root)
    register_all_voc_sbd(root)
