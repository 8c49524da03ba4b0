from .voc import (VOC_CLASS_NAMES, image_level_labels, load_voc_instances,
                  register_all_pascal_voc, register_pascal_voc)

__all__ = ["VOC_CLASS_NAMES", "image_level_labels", "load_voc_instances",
           "register_all_pascal_voc", "register_pascal_voc"]
