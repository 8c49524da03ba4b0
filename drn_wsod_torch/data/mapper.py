"""Image decoding, size buckets and the dataset mapper (counterpart of
``drn_wsod_tpu/data/mapper.py``).

``DatasetMapper`` turns one dataset record into a fixed-shape sample: the
augmentations (crop, multi-scale shortest-edge resize and flip in training,
the test resize otherwise), the proposals mapped the same way and padded to
``BATCH_SIZE_PER_IMAGE`` slots, the image padded into a square size bucket
(``INPUT.BUCKETS``) as uint8, padded instance GT and image-level labels;
with ``MASK_ON`` each instance's COCO polygons filled on the bucket's canvas
(``structures/masks.py:fill_polygon``, Pillow's fill without Pillow) as
(G, bucket, bucket) uint8 ``gt_masks``, with ``KEYPOINT_ON`` its keypoints
as (G, K, 3) ``gt_keypoints``; where the record names a
``sem_seg_file_name``, its label map moved with the image (nearest
sampling) onto a (bucket, bucket) int32 canvas of
``SEM_SEG_HEAD.IGNORE_VALUE`` as ``sem_seg``. JPEG files decode with the
port's own decoder (``native.py``) and PNG files with its own reader
(``data/png.py``), told apart by their content, neither needing Pillow;
packed records (``data/record_dataset.py``) carry decoded pixels and skip
the decode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native
from ..structures.masks import fill_polygon
from . import transforms as T
from .png import SIGNATURE, read_png, read_png_rgb
from .datasets.voc import image_level_labels
from .proposals import transform_proposals


def _sniff(path: str):
    """(the file's bytes, "png", "jpeg" or None) by its first bytes, as
    Pillow tells formats apart; the file's name plays no part."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(SIGNATURE):
        return data, "png"
    if data.startswith(b"\xff\xd8"):
        return data, "jpeg"
    return data, None


def _pillow(path: str, rgb: bool) -> np.ndarray:
    """A format neither of the port's readers takes (GIF, BMP, WebP,
    TIFF, ...), through Pillow where it imports."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path!r} needs Pillow (the PIL package): it is "
            "neither PNG nor JPEG; pack the dataset with decoded pixels "
            "(drn_wsod_torch.tools.pack_dataset) to train without it"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB") if rgb else im)


def _jpeg(path: str, data: bytes, native_mode: bool) -> np.ndarray:
    arr, status = native.jpeg_decode_status(data, 8, native_mode)
    if arr is None:
        raise ValueError(
            f"cannot decode {path!r}: "
            f"{native.REASONS.get(status, f'status {status}')}, which "
            "neither libjpeg nor Pillow decodes")
    return arr


def read_image(path: str, fmt: str = "BGR") -> np.ndarray:
    """Decode an image file to an (H, W, 3) uint8 array in ``fmt`` channel
    order ("BGR" or "RGB"), as the JAX package's ``read_image`` does with
    Pillow present, on a machine without it. The file's content decides,
    not its name: a JPEG goes through the port's JPEG decoder
    (``native.jpeg_decode_status``: libjpeg's decode where libjpeg takes
    the file, Pillow's ``convert("RGB")`` for the CMYK, YCCK and lossless
    files only Pillow takes), a PNG through the port's PNG reader
    (``data/png.py:read_png_rgb``, Pillow's ``convert("RGB")``). A JPEG
    neither reference decodes (12-bit, hierarchical, a corrupt header,
    ...) raises a ``ValueError`` naming the file and the feature; another
    format decodes with Pillow, and raises an ``ImportError`` without
    it."""
    data, kind = _sniff(path)
    if kind == "png":
        arr = read_png_rgb(path)
    elif kind == "jpeg":
        arr = _jpeg(path, data, False)
    else:
        arr = _pillow(path, rgb=True)
    if fmt == "BGR":
        arr = arr[:, :, ::-1]
    return np.ascontiguousarray(arr)


def read_label_map(path: str) -> np.ndarray:
    """A label map as ``np.asarray(Image.open(path))``, by the file's
    content: a PNG through the port's reader (a palette file gives its
    indices, a 16-bit one uint16), a JPEG through its decoder in Pillow's
    mode (L, RGB or CMYK), another format through Pillow."""
    data, kind = _sniff(path)
    if kind == "png":
        return read_png(path)
    if kind == "jpeg":
        return _jpeg(path, data, True)
    return _pillow(path, rgb=False)


def pick_bucket(h: int, w: int, buckets: Sequence[int],
                divisibility: int = 32) -> int:
    """Smallest square bucket covering (h, w); beyond the largest, the
    longer side rounded up to ``divisibility``."""
    m = max(h, w)
    for b in sorted(buckets):
        if b >= m:
            return b
    return int(np.ceil(m / divisibility) * divisibility)


class DatasetMapper:
    """Record -> fixed-shape sample, for training (``is_train``: the
    config's crop, ``MIN_SIZE_TRAIN`` resize and flip) or test (the
    ``MIN_SIZE_TEST`` resize)."""

    def __init__(self, cfg, is_train: bool, num_classes: Optional[int] = None):
        self.is_train = is_train
        self.num_classes = num_classes or cfg.MODEL.ROI_HEADS.NUM_CLASSES
        self.fmt = cfg.INPUT.FORMAT
        self.buckets = tuple(cfg.INPUT.BUCKETS)
        self.divisibility = cfg.INPUT.SIZE_DIVISIBILITY
        self.num_proposals = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
        self.min_box_size = cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE
        self.topk = (cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if is_train
                     else cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)
        self.max_gt = cfg.DATASETS.MAX_GT_PER_IMAGE
        self.mask_on = cfg.MODEL.MASK_ON
        self.keypoint_on = cfg.MODEL.KEYPOINT_ON
        self.num_keypoints = cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS
        self.sem_ignore = cfg.MODEL.SEM_SEG_HEAD.IGNORE_VALUE

        augs: List[T.Augmentation] = []
        if is_train:
            if cfg.INPUT.CROP.ENABLED:
                augs.append(T.RandomCrop(cfg.INPUT.CROP.TYPE,
                                         cfg.INPUT.CROP.SIZE))
            augs.append(T.ResizeShortestEdge(
                tuple(cfg.INPUT.MIN_SIZE_TRAIN), cfg.INPUT.MAX_SIZE_TRAIN,
                cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING))
            if cfg.INPUT.RANDOM_FLIP != "none":
                augs.append(T.RandomFlip(0.5))
        else:
            augs.append(T.ResizeShortestEdge(
                cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST))
        self.augmentations = augs

    def plan_bucket(self, record: Dict, rng: np.random.RandomState) -> int:
        """The sample's size bucket from the record's metadata alone, no
        decode. It draws from ``rng`` exactly as ``__call__`` does (the
        augmentations read only the image's shape and the rng), so a fresh
        RandomState of the same seed gives the same transforms at decode
        time."""
        if "image" in record:
            h, w = record["image"].shape[:2]
        else:
            h, w = int(record["height"]), int(record["width"])
        for aug in self.augmentations:
            dummy = np.broadcast_to(np.zeros((), np.uint8), (h, w, 3))
            h, w = aug.get_transform(dummy, rng).output_size((h, w))
        return pick_bucket(h, w, self.buckets, self.divisibility)

    def __call__(self, record: Dict, rng: np.random.RandomState,
                 dataset_index: int = 0) -> Dict[str, np.ndarray]:
        if "image" in record:
            # packed record (data/record_dataset.py): decoded BGR pixels
            image = record["image"]
            if self.fmt == "RGB":
                image = image[:, :, ::-1]
        else:
            image = read_image(record["file_name"], self.fmt)
        orig_h, orig_w = image.shape[:2]

        image, tfms = T.apply_augmentations(self.augmentations, image, rng)
        h, w = image.shape[:2]

        if "proposal_boxes" in record:
            boxes, logits = transform_proposals(
                record, (h, w), tfms, min_box_size=self.min_box_size,
                topk=self.topk)
        else:
            boxes = np.zeros((0, 4), dtype=np.float32)
            logits = np.zeros((0,), dtype=np.float32)

        P = self.num_proposals
        n = min(len(boxes), P)
        prop = np.zeros((P, 4), dtype=np.float32)
        obj = np.zeros((P,), dtype=np.float32)
        mask = np.zeros((P,), dtype=bool)
        prop[:n] = boxes[:n]
        obj[:n] = logits[:n]
        mask[:n] = True

        bucket = pick_bucket(h, w, self.buckets, self.divisibility)
        # pixels stay uint8 up to the model, which promotes them on the
        # device: a quarter of float32's bytes to copy
        canvas = np.zeros((bucket, bucket, 3),
                          dtype=np.uint8 if image.dtype == np.uint8
                          else np.float32)
        canvas[:h, :w] = image

        # padded instance GT, without the difficult objects
        G = self.max_gt
        gt_boxes = np.zeros((G, 4), dtype=np.float32)
        gt_classes = np.zeros((G,), dtype=np.int32)
        gt_valid = np.zeros((G,), dtype=bool)
        annos = [a for a in record.get("annotations", [])
                 if not a.get("difficult", 0)]
        for i, a in enumerate(annos[:G]):
            b = tfms.apply_box(np.asarray([a["bbox"]], np.float32))[0]
            gt_boxes[i] = np.clip(b, 0, [w, h, w, h])
            gt_classes[i] = a["category_id"]
            gt_valid[i] = True

        extra: Dict[str, np.ndarray] = {}
        if self.mask_on:
            # every polygon of the instance filled on the canvas, in the
            # transformed frame; the JAX mapper draws each with Pillow
            masks = np.zeros((G, bucket, bucket), dtype=bool)
            for i, a in enumerate(annos[:G]):
                for poly in a.get("segmentation") or []:
                    pts = np.asarray(poly, np.float32).reshape(-1, 2)
                    fill_polygon(masks[i], tfms.apply_coords(pts))
            extra["gt_masks"] = masks.view(np.uint8)
        if self.keypoint_on:
            # (x, y, visibility) moved with the image; left and right are
            # not swapped under a flip, as in the JAX mapper, whose flip
            # indices are always None
            K = self.num_keypoints
            kpts = np.zeros((G, K, 3), dtype=np.float32)
            for i, a in enumerate(annos[:G]):
                kp = np.asarray(a.get("keypoints", []),
                                np.float32).reshape(-1, 3)[:K]
                if not len(kp):
                    continue
                kp = kp.copy()
                kp[:, :2] = tfms.apply_coords(kp[:, :2])
                kpts[i, :len(kp)] = kp
            extra["gt_keypoints"] = kpts
        if "sem_seg_file_name" in record:
            sem = tfms.apply_segmentation(
                read_label_map(record["sem_seg_file_name"]))
            canvas_sem = np.full((bucket, bucket), self.sem_ignore, np.int32)
            canvas_sem[:h, :w] = sem.astype(np.int32)
            extra["sem_seg"] = canvas_sem

        return {
            **extra,
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "image": canvas,
            "image_hw": np.asarray([h, w], dtype=np.int32),
            "orig_hw": np.asarray([orig_h, orig_w], dtype=np.int32),
            "proposals": prop,
            "proposal_mask": mask,
            "objectness": obj,
            "labels": image_level_labels(record, self.num_classes),
            "image_id": np.asarray(dataset_index, dtype=np.int32),
            "_bucket": bucket,
        }
