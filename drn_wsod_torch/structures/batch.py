"""Fixed-shape batch and detection containers (counterparts of
``drn_wsod_tpu/structures/batch.py:WSODBatch`` and ``Detections``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class WSODBatch:
    """A padded batch; every field is a tensor (the GT fields may be None).

    Attributes:
      image: (B, H, W, 3) raw pixels, NHWC: uint8 from the data loader,
        float32 from the TTA views and the synthetic batches.
      image_hw: (B, 2) int32 valid (height, width) inside the padded canvas.
      orig_hw: (B, 2) int32 original image size, for rescaling detections.
      proposals: (B, P, 4) float32 XYXY boxes in the (resized) image frame.
      proposal_mask: (B, P) bool validity of each padded proposal slot.
      objectness: (B, P) float32 proposal objectness.
      labels: (B, C) float32 multi-hot image-level class labels.
      image_id: (B,) int32 index into the dataset records.
      gt_boxes, gt_classes, gt_valid: (B, G, 4) float32, (B, G) int32 and
        (B, G) bool padded instance GT (the WSOD heads read only
        ``labels``).
      gt_masks: (B, G, H, W) uint8 {0, 1} instance masks on the padded
        canvas (Mask R-CNN; the model casts them to float32 on the device).
      gt_keypoints: (B, G, K, 3) float32 (x, y, visibility) (Keypoint
        R-CNN).
      sem_seg: (B, H, W) int32 per-pixel class labels on the padded canvas,
        the ignore value (255 by default) outside the image (the semantic
        and panoptic models).
    """

    image: torch.Tensor
    image_hw: torch.Tensor
    orig_hw: torch.Tensor
    proposals: torch.Tensor
    proposal_mask: torch.Tensor
    objectness: torch.Tensor
    labels: torch.Tensor
    image_id: torch.Tensor
    gt_boxes: Optional[torch.Tensor] = None
    gt_classes: Optional[torch.Tensor] = None
    gt_valid: Optional[torch.Tensor] = None
    gt_masks: Optional[torch.Tensor] = None
    gt_keypoints: Optional[torch.Tensor] = None
    sem_seg: Optional[torch.Tensor] = None

    def tensors(self) -> dict:
        """{field: tensor} of the fields that are set."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    def map(self, fn) -> "WSODBatch":
        """A copy with ``fn`` applied to every tensor that is set."""
        return WSODBatch(**{k: fn(v) for k, v in self.tensors().items()})

    def to(self, device, non_blocking: bool = False) -> "WSODBatch":
        """A copy with every field on ``device``."""
        return self.map(lambda t: t.to(device, non_blocking=non_blocking))

    def replace(self, **changes) -> "WSODBatch":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Detections:
    """Fixed-size detections of a batch, padded slots with score -1.

    Attributes:
      boxes: (B, D, 4) float32 XYXY.
      scores: (B, D) float32.
      classes: (B, D) int32.
      valid: (B, D) bool.
      all_scores: optional (B, P, C + 1) proposal-by-class scores, for TTA.
      all_boxes: optional (B, P, 4) or (B, P, C * 4) boxes, for TTA.
    """

    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    all_scores: Optional[torch.Tensor] = None
    all_boxes: Optional[torch.Tensor] = None
