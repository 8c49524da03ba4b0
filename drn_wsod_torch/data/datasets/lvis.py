"""LVIS datasets (counterpart of ``drn_wsod_tpu/data/datasets/lvis.py``).

An LVIS json is COCO-shaped, with per-image ``neg_category_ids`` (classes
verified absent) and ``not_exhaustive_category_ids`` (classes whose
instances are not all annotated), which the records carry as contiguous
ids for the federated evaluation (``evaluation/lvis_eval.py``).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from ..catalog import DatasetCatalog, MetadataCatalog


def load_lvis_json(json_file: str, image_root: str,
                   dataset_name: Optional[str] = None) -> List[dict]:
    """The images of an LVIS json as records: categories sorted by id and
    mapped to contiguous ids, boxes from XYWH to XYXY, the file name from
    ``coco_url`` where ``file_name`` is absent (LVIS v1). Where
    ``dataset_name`` is given, its metadata gets the class names, each
    class's frequency tag (``frequency``: r, c or f; f where missing),
    the paths and the "lvis" evaluator type."""
    with open(json_file) as f:
        data = json.load(f)

    cats = sorted(data["categories"], key=lambda c: c["id"])
    id_map = {c["id"]: i for i, c in enumerate(cats)}
    if dataset_name is not None:
        MetadataCatalog.get(dataset_name).set(
            thing_classes=[c["name"] for c in cats],
            thing_frequencies=[c.get("frequency", "f") for c in cats],
            json_file=json_file, image_root=image_root,
            evaluator_type="lvis")

    anns_by_image = {}
    for a in data.get("annotations", []):
        anns_by_image.setdefault(a["image_id"], []).append(a)

    dicts = []
    for img in data["images"]:
        file_name = img.get("file_name") or img["coco_url"].split("/")[-1]
        annos = []
        for a in anns_by_image.get(img["id"], []):
            x, y, w, h = a["bbox"]
            annos.append({"category_id": id_map[a["category_id"]],
                          "bbox": [x, y, x + w, y + h],
                          "bbox_mode": "XYXY_ABS", "difficult": 0})
        dicts.append({
            "file_name": os.path.join(image_root, file_name),
            "height": img["height"], "width": img["width"],
            "image_id": img["id"],
            "neg_category_ids": [id_map[c] for c in
                                 img.get("neg_category_ids", [])],
            "not_exhaustive_category_ids": [
                id_map[c] for c in img.get("not_exhaustive_category_ids", [])],
            "annotations": annos})
    return dicts


def register_lvis_instances(name: str, json_file: str, image_root: str):
    DatasetCatalog.register(
        name, lambda: load_lvis_json(json_file, image_root, name))
    MetadataCatalog.get(name).set(json_file=json_file, image_root=image_root,
                                  evaluator_type="lvis")


_BUILTIN_LVIS = {
    "lvis_v1_train": ("coco/", "lvis/lvis_v1_train.json"),
    "lvis_v1_val": ("coco/", "lvis/lvis_v1_val.json"),
}


def register_all_lvis(root: str = "datasets"):
    """Register the LVIS v1 splits under ``root`` (images under ``coco/``,
    the json under ``lvis/``), each name once."""
    for name, (image_root, json_file) in _BUILTIN_LVIS.items():
        if name not in DatasetCatalog:
            register_lvis_instances(name, os.path.join(root, json_file),
                                    os.path.join(root, image_root))
