"""The eval path's data modules: catalogs, the VOC loader, precomputed
proposals, transforms and image decoding. The train and eval loaders and
the dataset mapper come with ROADMAP.md queue 1, item 10."""

from .catalog import DatasetCatalog, Metadata, MetadataCatalog
from .loader import get_detection_dataset_dicts
from .mapper import pick_bucket, read_image
from .proposals import load_proposals_into_dataset

__all__ = ["DatasetCatalog", "Metadata", "MetadataCatalog",
           "get_detection_dataset_dicts", "load_proposals_into_dataset",
           "pick_bucket", "read_image"]
