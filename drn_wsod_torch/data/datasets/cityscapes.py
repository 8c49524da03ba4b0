"""Cityscapes instance and semantic datasets (counterpart of
``drn_wsod_tpu/data/datasets/cityscapes.py``).

Scans the ``leftImg8bit/<split>/<city>`` image tree against
``gtFine/<split>/<city>`` and parses the ``*_gtFine_polygons.json`` files
directly: boxes are the polygons' extents, and each polygon is kept as the
record's segmentation. The 8 "thing" classes follow the Cityscapes label
spec. A "...group" label (a crowd region) becomes its class with
``iscrowd`` 1; a ``deleted`` object, or a label outside the 8, is skipped.
The semantic records name the raw ``*_gtFine_labelIds.png`` maps: the
labelId -> trainId mapping happens only in the evaluator
(``evaluation/cityscapes_eval.py``).
"""

from __future__ import annotations

import json
import os
from typing import List

from ..catalog import DatasetCatalog, MetadataCatalog

CITYSCAPES_THING_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle",
]

_GROUP_SUFFIX = "group"
_IMAGE_SUFFIX = "leftImg8bit.png"


def _files(image_dir: str, gt_dir: str):
    """(image, polygon json, labelIds png) paths of every
    ``*_leftImg8bit.png`` under ``image_dir``'s city folders, sorted."""
    out = []
    for city in sorted(os.listdir(image_dir)):
        city_img = os.path.join(image_dir, city)
        if not os.path.isdir(city_img):
            continue
        for basename in sorted(os.listdir(city_img)):
            if not basename.endswith(_IMAGE_SUFFIX):
                continue
            stem = basename[:-len(_IMAGE_SUFFIX)]
            out.append((
                os.path.join(city_img, basename),
                os.path.join(gt_dir, city, stem + "gtFine_polygons.json"),
                os.path.join(gt_dir, city, stem + "gtFine_labelIds.png"),
            ))
    return out


def _image_id(image_file: str) -> str:
    return os.path.basename(image_file)[:-len("_" + _IMAGE_SUFFIX)]


def load_cityscapes_instances(image_dir: str, gt_dir: str) -> List[dict]:
    """Instance records from the polygon json files."""
    name_to_id = {n: i for i, n in enumerate(CITYSCAPES_THING_CLASSES)}
    dicts = []
    for image_file, json_file, _ in _files(image_dir, gt_dir):
        with open(json_file) as f:
            ann = json.load(f)
        annos = []
        for obj in ann["objects"]:
            if obj.get("deleted"):
                continue
            label = obj["label"]
            iscrowd = 0
            if label.endswith(_GROUP_SUFFIX):
                label = label[:-len(_GROUP_SUFFIX)]
                iscrowd = 1
            if label not in name_to_id:
                continue
            poly = obj["polygon"]
            xs = [p[0] for p in poly]
            ys = [p[1] for p in poly]
            annos.append({
                "category_id": name_to_id[label],
                "bbox": [min(xs), min(ys), max(xs), max(ys)],
                "bbox_mode": "XYXY_ABS",
                "difficult": 0,
                "iscrowd": iscrowd,
                "segmentation": [[c for p in poly for c in p]],
            })
        dicts.append({"file_name": image_file, "height": ann["imgHeight"],
                      "width": ann["imgWidth"],
                      "image_id": _image_id(image_file),
                      "annotations": annos})
    return dicts


def load_cityscapes_semantic(image_dir: str, gt_dir: str) -> List[dict]:
    """Semantic records: the image and its raw labelIds map."""
    dicts = []
    for image_file, json_file, label_file in _files(image_dir, gt_dir):
        with open(json_file) as f:
            ann = json.load(f)
        dicts.append({"file_name": image_file,
                      "sem_seg_file_name": label_file,
                      "height": ann["imgHeight"], "width": ann["imgWidth"],
                      "image_id": _image_id(image_file)})
    return dicts


_SPLITS = {
    "cityscapes_fine_instance_seg_train": ("leftImg8bit/train", "gtFine/train"),
    "cityscapes_fine_instance_seg_val": ("leftImg8bit/val", "gtFine/val"),
    "cityscapes_fine_instance_seg_test": ("leftImg8bit/test", "gtFine/test"),
}


def register_all_cityscapes(root: str = "datasets"):
    """Register each split under ``root/cityscapes`` twice, each name once:
    ``cityscapes_fine_instance_seg_*`` ("cityscapes_instance") and
    ``cityscapes_fine_sem_seg_*`` ("cityscapes_sem_seg")."""
    for name, (img, gt) in _SPLITS.items():
        if name in DatasetCatalog:
            continue
        image_dir = os.path.join(root, "cityscapes", img)
        gt_dir = os.path.join(root, "cityscapes", gt)
        DatasetCatalog.register(
            name, lambda i=image_dir, g=gt_dir: load_cityscapes_instances(i, g))
        MetadataCatalog.get(name).set(
            thing_classes=list(CITYSCAPES_THING_CLASSES),
            image_dir=image_dir, gt_dir=gt_dir,
            evaluator_type="cityscapes_instance")
        sem_name = name.replace("instance_seg", "sem_seg")
        DatasetCatalog.register(
            sem_name,
            lambda i=image_dir, g=gt_dir: load_cityscapes_semantic(i, g))
        MetadataCatalog.get(sem_name).set(
            image_dir=image_dir, gt_dir=gt_dir,
            evaluator_type="cityscapes_sem_seg")
