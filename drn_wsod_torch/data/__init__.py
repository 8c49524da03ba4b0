"""The data path: catalogs, the VOC loader, precomputed proposals,
transforms and augmentations, the dataset mapper, packed record shards and
the train and eval loaders."""

from .catalog import DatasetCatalog, Metadata, MetadataCatalog
from .loader import (EvalLoader, TrainLoader, build_detection_test_loader,
                     build_detection_train_loader,
                     get_detection_dataset_dicts)
from .mapper import DatasetMapper, pick_bucket, read_image
from .proposals import load_proposals_into_dataset, transform_proposals
from .record_dataset import RecordDataset, pack_dataset, write_records

__all__ = ["DatasetCatalog", "DatasetMapper", "EvalLoader", "Metadata",
           "MetadataCatalog", "RecordDataset", "TrainLoader",
           "build_detection_test_loader", "build_detection_train_loader",
           "get_detection_dataset_dicts", "load_proposals_into_dataset",
           "pack_dataset", "pick_bucket", "read_image",
           "transform_proposals", "write_records"]
