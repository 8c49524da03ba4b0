"""COCO-format json datasets (counterpart of
``drn_wsod_tpu/data/datasets/coco.py``): the boxes and class labels WSOD
needs; segmentation, keypoints and area are carried through unchanged.
The panoptic splits in the "separated" flavour add to each image's
instance record its panoptic PNG and segments (for PQ) and its stuff
label PNG (for the semantic branch).
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


def load_coco_panoptic_separated(panoptic_json: str, image_root: str,
                                 panoptic_root: str, sem_seg_root: str,
                                 instances_json: str,
                                 dataset_name: Optional[str] = None
                                 ) -> List[dict]:
    """COCO panoptic, "separated": the instances json's records (the thing
    branch), each with ``sem_seg_file_name`` (its PNG under
    ``sem_seg_root``: 0 the "thing" class, stuff l >= 1) and
    ``pan_seg_file_name`` (its panoptic PNG) with ``segments_info``, whose
    category ids are mapped to the PQ space (thing c -> c, contiguous by
    id; stuff -> n_thing + l - 1; segments of other categories dropped).
    Where ``dataset_name`` is given, its metadata gets ``stuff_classes``
    ("things" first) and ``stuff_dataset_id_to_contiguous_id``."""
    records = load_coco_json(instances_json, image_root, dataset_name)
    with open(panoptic_json) as f:
        pan = json.load(f)
    things = [c for c in pan.get("categories", []) if c.get("isthing")]
    stuffs = sorted((c for c in pan.get("categories", [])
                     if not c.get("isthing")), key=lambda c: c["id"])
    thing_map = {c["id"]: i for i, c in
                 enumerate(sorted(things, key=lambda c: c["id"]))}
    stuff_map = {c["id"]: i + 1 for i, c in enumerate(stuffs)}
    n_thing = len(thing_map)
    if dataset_name is not None:
        MetadataCatalog.get(dataset_name).set(
            stuff_classes=["things"] + [c["name"] for c in stuffs],
            stuff_dataset_id_to_contiguous_id=stuff_map)

    by_image = {p["image_id"]: p for p in pan.get("annotations", [])}
    for r in records:
        p = by_image.get(r["image_id"])
        if p is None:
            continue
        segments = []
        for seg in p.get("segments_info", []):
            cid = seg["category_id"]
            if cid in thing_map:
                cat, isthing = thing_map[cid], True
            elif cid in stuff_map:
                cat, isthing = n_thing + stuff_map[cid] - 1, False
            else:
                continue
            segments.append({"id": seg["id"], "category_id": cat,
                             "isthing": isthing})
        r["pan_seg_file_name"] = os.path.join(panoptic_root, p["file_name"])
        r["segments_info"] = segments
        r["sem_seg_file_name"] = os.path.join(sem_seg_root, p["file_name"])
    return records


def register_coco_panoptic_separated(name: str, image_root: str,
                                     panoptic_root: str, panoptic_json: str,
                                     sem_seg_root: str, instances_json: str):
    DatasetCatalog.register(
        name, lambda: load_coco_panoptic_separated(
            panoptic_json, image_root, panoptic_root, sem_seg_root,
            instances_json, name))
    MetadataCatalog.get(name).set(
        panoptic_json=panoptic_json, image_root=image_root,
        panoptic_root=panoptic_root, sem_seg_root=sem_seg_root,
        json_file=instances_json, evaluator_type="coco_panoptic_seg")


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

_BUILTIN_COCO_PANOPTIC = {
    "coco_2017_train_panoptic_separated": (
        "coco/train2017", "coco/panoptic_train2017",
        "coco/annotations/panoptic_train2017.json",
        "coco/panoptic_stuff_train2017",
        "coco/annotations/instances_train2017.json"),
    "coco_2017_val_panoptic_separated": (
        "coco/val2017", "coco/panoptic_val2017",
        "coco/annotations/panoptic_val2017.json",
        "coco/panoptic_stuff_val2017",
        "coco/annotations/instances_val2017.json"),
}


def register_all_coco(root: str = "datasets"):
    """Register the builtin COCO splits and the panoptic-separated ones
    under ``root``, each name once."""
    for name, (image_root, json_file) in _BUILTIN_COCO.items():
        if name not in DatasetCatalog:
            register_coco_instances(
                name, os.path.join(root, json_file),
                os.path.join(root, image_root))
    for name, paths in _BUILTIN_COCO_PANOPTIC.items():
        if name not in DatasetCatalog:
            image_root, pan_root, pan_json, sem_root, inst_json = (
                os.path.join(root, p) for p in paths)
            register_coco_panoptic_separated(name, image_root, pan_root,
                                             pan_json, sem_root, inst_json)
