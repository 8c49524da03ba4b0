"""The web (Flickr) and VOC-SBD instance datasets, both COCO-format json
(counterpart of ``drn_wsod_tpu/data/datasets/builtin_web.py``), and the
VOC label colormap.

A split is registered only where its json exists: the web images and the
SBD instance annotations are optional.
"""

from __future__ import annotations

import os

import numpy as np

from ..catalog import DatasetCatalog, MetadataCatalog
from .coco import register_coco_instances
from .voc import VOC_CLASS_NAMES

_WEB_SPLITS = {
    "flickr_voc": ("flickr_voc/images",
                   "flickr_voc/annotations/instances.json"),
    "flickr_coco": ("flickr_coco/images",
                    "flickr_coco/annotations/instances.json"),
}

# the VOC-2012 + SBD instance splits the WSJDS segmentation configs name
_VOC_SBD_SPLITS = {
    "voc_2012_train_instance": (
        "VOC_SBD/images",
        "VOC_SBD/annotations/voc_2012_train_instance.json"),
    "voc_2012_val_instance": (
        "VOC_SBD/images",
        "VOC_SBD/annotations/voc_2012_val_instance.json"),
    "sbd_9118_instance": (
        "VOC_SBD/images",
        "VOC_SBD/annotations/sbd_9118_instance.json"),
}


def _register_present(splits: dict, root: str):
    for name, (image_dir, json_file) in splits.items():
        jf = os.path.join(root, json_file)
        if name in DatasetCatalog or not os.path.exists(jf):
            continue
        register_coco_instances(name, jf, os.path.join(root, image_dir))
        MetadataCatalog.get(name).set(evaluator_type="coco")


def register_all_web(root: str = "datasets"):
    _register_present(_WEB_SPLITS, root)


def register_all_voc_sbd(root: str = "datasets"):
    _register_present(_VOC_SBD_SPLITS, root)


def voc_label_colormap(n: int = 256) -> np.ndarray:
    """The VOC bit-interleaved colormap, (n, 3) uint8."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= (c & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


VOC_COLORMAP = {name: tuple(int(v) for v in voc_label_colormap()[i + 1])
                for i, name in enumerate(VOC_CLASS_NAMES)}
