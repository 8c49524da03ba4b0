"""Fixed-shape batch container (counterpart of
``drn_wsod_tpu/structures/batch.py:WSODBatch``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class WSODBatch:
    """A padded eval batch; every field is a tensor.

    Attributes:
      image: (B, H, W, 3) float32 raw pixels, NHWC.
      image_hw: (B, 2) int32 valid (height, width) inside the padded canvas.
      orig_hw: (B, 2) int32 original image size, for rescaling detections.
      proposals: (B, P, 4) float32 XYXY boxes in the (resized) image frame.
      proposal_mask: (B, P) bool validity of each padded proposal slot.
      objectness: (B, P) float32 proposal objectness.
      labels: (B, C) float32 multi-hot image-level class labels.
      image_id: (B,) int32 index into the dataset records.
    """

    image: torch.Tensor
    image_hw: torch.Tensor
    orig_hw: torch.Tensor
    proposals: torch.Tensor
    proposal_mask: torch.Tensor
    objectness: torch.Tensor
    labels: torch.Tensor
    image_id: torch.Tensor

    def to(self, device, non_blocking: bool = False) -> "WSODBatch":
        """A copy with every field on ``device``."""
        return WSODBatch(**{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)})

    def replace(self, **changes) -> "WSODBatch":
        return dataclasses.replace(self, **changes)
