from . import boxes
from .batch import Detections, WSODBatch
from .boxes import (BoxMode, area, apply_deltas, clip, get_deltas, nonempty,
                    pairwise_intersection, pairwise_iou, pairwise_iou_wsl,
                    unique_boxes_mask)
from .rotated_boxes import (nms_rotated, pairwise_iou_rotated,
                            rotated_to_corners)

__all__ = ["BoxMode", "Detections", "WSODBatch", "apply_deltas", "area",
           "boxes", "clip", "get_deltas", "nms_rotated", "nonempty",
           "pairwise_intersection", "pairwise_iou", "pairwise_iou_rotated",
           "pairwise_iou_wsl", "rotated_to_corners", "unique_boxes_mask"]
