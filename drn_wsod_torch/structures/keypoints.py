"""Keypoints (counterpart of ``drn_wsod_tpu/structures/keypoints.py``):
per-instance (K, 3) arrays of (x, y, visibility), with the heatmap
targets of the keypoint head."""

from __future__ import annotations

import numpy as np
import torch

from ..models.heads.keypoint import keypoints_to_heatmap_targets


class Keypoints:
    """(N, K, 3) float32 keypoints: x, y, visibility (0 not labelled, 1
    labelled but not visible, 2 visible)."""

    def __init__(self, keypoints: np.ndarray):
        k = np.asarray(keypoints, np.float32)
        if k.ndim != 3 or k.shape[2] != 3:
            raise ValueError(f"Keypoints takes (N, K, 3), got {k.shape}")
        self.tensor = k

    def __len__(self) -> int:
        return self.tensor.shape[0]

    def __getitem__(self, item) -> "Keypoints":
        if isinstance(item, int):
            return Keypoints(self.tensor[item:item + 1])
        return Keypoints(self.tensor[item])

    def to_heatmap(self, boxes: np.ndarray, heatmap_size: int):
        """Each keypoint's flat cell index in its (N, 4) box's
        ``heatmap_size``-square heatmap, (N, K) int, and its validity,
        (N, K) bool (``models/heads/keypoint.py``)."""
        t, v = keypoints_to_heatmap_targets(
            torch.from_numpy(self.tensor),
            torch.from_numpy(np.asarray(boxes, np.float32)), heatmap_size)
        return t.numpy(), v.numpy()
