"""Pascal VOC XML dataset loader (counterpart of
``drn_wsod_tpu/data/datasets/voc.py``)."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from ..catalog import DatasetCatalog, MetadataCatalog

VOC_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def load_voc_instances(dirname: str, split: str,
                       class_names=VOC_CLASS_NAMES) -> List[dict]:
    """Load VOC annotations for a split into Detectron2-style dicts
    (file_name, image_id, height, width, annotations[{bbox, bbox_mode,
    category_id, difficult}]). Boxes are converted to 0-based XYXY."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]

    dicts = []
    for fileid in fileids:
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        r = {"file_name": os.path.join(dirname, "JPEGImages", fileid + ".jpg"),
             "image_id": fileid}
        instances = []
        if os.path.exists(anno_file):
            tree = ET.parse(anno_file)
            size = tree.find("size")
            if size is not None:
                r["height"] = int(float(size.find("height").text))
                r["width"] = int(float(size.find("width").text))
            for obj in tree.findall("object"):
                cls = obj.find("name").text
                if cls not in class_names:
                    continue
                difficult = int(obj.find("difficult").text) \
                    if obj.find("difficult") is not None else 0
                bb = obj.find("bndbox")
                # VOC is 1-based inclusive: the origin corner loses 1.0
                bbox = [float(bb.find(x).text) for x in
                        ("xmin", "ymin", "xmax", "ymax")]
                bbox[0] -= 1.0
                bbox[1] -= 1.0
                instances.append({
                    "category_id": class_names.index(cls),
                    "bbox": bbox,
                    "bbox_mode": "XYXY_ABS",
                    "difficult": difficult,
                })
        r["annotations"] = instances
        dicts.append(r)
    return dicts


def register_pascal_voc(name: str, dirname: str, split: str, year: int,
                        class_names=VOC_CLASS_NAMES):
    DatasetCatalog.register(name, lambda: load_voc_instances(dirname, split,
                                                             class_names))
    MetadataCatalog.get(name).set(
        thing_classes=list(class_names), dirname=dirname, year=year,
        split=split, evaluator_type="pascal_voc")


def register_all_pascal_voc(root: str):
    """Register the standard VOC07/12 splits under ``root``; names already
    registered are left as they are."""
    SPLITS = [
        ("voc_2007_trainval", "VOC2007", "trainval"),
        ("voc_2007_train", "VOC2007", "train"),
        ("voc_2007_val", "VOC2007", "val"),
        ("voc_2007_test", "VOC2007", "test"),
        ("voc_2012_trainval", "VOC2012", "trainval"),
        ("voc_2012_train", "VOC2012", "train"),
        ("voc_2012_val", "VOC2012", "val"),
    ]
    for name, dirname, split in SPLITS:
        if name in DatasetCatalog:
            continue
        year = 2007 if "2007" in name else 2012
        register_pascal_voc(name, os.path.join(root, dirname), split, year)


def image_level_labels(record: dict, num_classes: int) -> np.ndarray:
    """Multi-hot image labels from instance annotations, the only
    supervision WSOD uses; an image whose objects are all difficult takes
    them all."""
    labels = np.zeros(num_classes, dtype=np.float32)
    for a in record.get("annotations", []):
        if not a.get("difficult", 0):
            labels[a["category_id"]] = 1.0
    if labels.sum() == 0:
        for a in record.get("annotations", []):
            labels[a["category_id"]] = 1.0
    return labels
