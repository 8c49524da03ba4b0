"""Register the builtin datasets under one root: what the JAX package's
``tools/train_net.py:main`` registers, but LVIS (ROADMAP.md queue 1,
item 15c)."""

from __future__ import annotations

from .builtin_web import register_all_voc_sbd, register_all_web
from .coco import register_all_coco
from .voc import register_all_pascal_voc


def register_all(root: str = "datasets") -> None:
    """VOC, COCO (its panoptic-separated splits too), and the web and
    VOC-SBD sets whose json exists."""
    register_all_pascal_voc(root)
    register_all_coco(root)
    register_all_web(root)
    register_all_voc_sbd(root)
