"""COCO-format json datasets (counterpart of
``drn_wsod_tpu/data/datasets/coco.py``): the boxes and class labels WSOD
needs; segmentation, keypoints and area are carried through unchanged.

The panoptic ("separated") splits are registered under their names, so
that the catalog holds what the JAX package's holds, but their loader is
not ported: loading one raises.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog


def load_coco_json(json_file: str, image_root: str,
                   dataset_name: Optional[str] = None) -> List[dict]:
    """The images of a COCO instances json as records: categories sorted
    by id and mapped to contiguous ids 0..C-1, boxes from XYWH to XYXY,
    ``difficult`` = ``iscrowd`` (crowd regions are skipped in training and
    ignored by the evaluator). Where ``dataset_name`` is given, its
    metadata gets the class names, the id map, the paths and the "coco"
    evaluator type."""
    with open(json_file) as f:
        coco = json.load(f)

    cats = sorted(coco.get("categories", []), key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name is not None:
        MetadataCatalog.get(dataset_name).set(
            thing_classes=[c["name"] for c in cats],
            thing_dataset_id_to_contiguous_id=id_map,
            json_file=json_file, image_root=image_root,
            evaluator_type="coco")

    anns_by_image = {}
    for a in coco.get("annotations", []):
        anns_by_image.setdefault(a["image_id"], []).append(a)

    dicts = []
    for img in coco["images"]:
        annos = []
        for a in anns_by_image.get(img["id"], []):
            x, y, w, h = a["bbox"]
            crowd = int(a.get("iscrowd", 0))
            anno = {"category_id": id_map[a["category_id"]],
                    "bbox": [x, y, x + w, y + h], "bbox_mode": "XYXY_ABS",
                    "difficult": crowd, "iscrowd": crowd}
            for key in ("segmentation", "keypoints", "area"):
                if key in a:
                    anno[key] = a[key]
            annos.append(anno)
        dicts.append({"file_name": os.path.join(image_root, img["file_name"]),
                      "height": img["height"], "width": img["width"],
                      "image_id": img["id"], "annotations": annos})
    return dicts


def register_coco_instances(name: str, json_file: str, image_root: str):
    DatasetCatalog.register(
        name, lambda: load_coco_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(
        json_file=json_file, image_root=image_root, evaluator_type="coco")


def _panoptic_not_ported(name: str):
    def load():
        raise NotImplementedError(
            f"dataset {name!r}: the COCO panoptic loader is not ported yet: "
            "ROADMAP.md queue 1, item 15 (remaining datasets)")
    return load


# the builtin COCO splits (Detectron2's data/datasets/builtin.py)
_BUILTIN_COCO = {
    "coco_2014_train": ("coco/train2014",
                        "coco/annotations/instances_train2014.json"),
    "coco_2014_val": ("coco/val2014",
                      "coco/annotations/instances_val2014.json"),
    "coco_2017_train": ("coco/train2017",
                        "coco/annotations/instances_train2017.json"),
    "coco_2017_val": ("coco/val2017",
                      "coco/annotations/instances_val2017.json"),
}

_BUILTIN_COCO_PANOPTIC = ("coco_2017_train_panoptic_separated",
                          "coco_2017_val_panoptic_separated")


def register_all_coco(root: str = "datasets"):
    """Register the builtin COCO splits under ``root`` (each name once),
    and the panoptic names with a loader that raises."""
    for name, (image_root, json_file) in _BUILTIN_COCO.items():
        if name not in DatasetCatalog:
            register_coco_instances(
                name, os.path.join(root, json_file),
                os.path.join(root, image_root))
    for name in _BUILTIN_COCO_PANOPTIC:
        if name not in DatasetCatalog:
            DatasetCatalog.register(name, _panoptic_not_ported(name))
            MetadataCatalog.get(name).set(evaluator_type="coco_panoptic_seg")
