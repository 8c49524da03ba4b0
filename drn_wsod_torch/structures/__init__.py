from . import boxes
from .batch import WSODBatch
from .boxes import BoxMode, unique_boxes_mask

__all__ = ["BoxMode", "WSODBatch", "boxes", "unique_boxes_mask"]
