from .builtin import register_all
from .builtin_web import (VOC_COLORMAP, register_all_voc_sbd,
                          register_all_web, voc_label_colormap)
from .cityscapes import (CITYSCAPES_THING_CLASSES, load_cityscapes_instances,
                         load_cityscapes_semantic, register_all_cityscapes)
from .coco import (load_coco_json, load_coco_panoptic_separated,
                   register_all_coco, register_coco_instances,
                   register_coco_panoptic_separated)
from .lvis import load_lvis_json, register_all_lvis, register_lvis_instances
from .voc import (VOC_CLASS_NAMES, image_level_labels, load_voc_instances,
                  register_all_pascal_voc, register_pascal_voc)

__all__ = ["CITYSCAPES_THING_CLASSES", "VOC_CLASS_NAMES", "VOC_COLORMAP",
           "image_level_labels", "load_cityscapes_instances",
           "load_cityscapes_semantic", "load_coco_json",
           "load_coco_panoptic_separated", "load_lvis_json",
           "load_voc_instances", "register_all", "register_all_cityscapes",
           "register_all_coco", "register_all_lvis",
           "register_all_pascal_voc", "register_all_voc_sbd",
           "register_all_web", "register_coco_instances",
           "register_coco_panoptic_separated", "register_lvis_instances",
           "register_pascal_voc", "voc_label_colormap"]
