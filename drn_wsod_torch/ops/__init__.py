from .nms import multiclass_nms, nms_mask
from .roi_align_rotated import roi_align_rotated
from .roi_pool import (roi_pool_batched, roi_pool_image, roi_pool_image_plain,
                       roi_pool_looped, roi_pool_plain)

__all__ = ["multiclass_nms", "nms_mask", "roi_align_rotated",
           "roi_pool_batched", "roi_pool_image", "roi_pool_image_plain",
           "roi_pool_looped", "roi_pool_plain"]
