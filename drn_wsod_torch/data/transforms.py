"""Host-side image and box transforms of the eval path (counterpart of the
parts of ``drn_wsod_tpu/data/transforms.py`` that TTA uses): the resize
transform, on PIL as in the JAX package, and the shortest-edge target size.
The random augmentations come with the data path (ROADMAP.md queue 1,
item 10).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class Transform:
    """A deterministic transform of images and of XYXY boxes."""

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_coords(self, coords: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_box(self, boxes: np.ndarray) -> np.ndarray:
        """Transform XYXY boxes through their 4 corners (handles flips)."""
        boxes = np.asarray(boxes, dtype=np.float32)
        idx = np.array([(0, 1), (2, 1), (0, 3), (2, 3)]).flatten()
        corners = boxes[:, idx].reshape(-1, 2)
        corners = self.apply_coords(corners).reshape(-1, 4, 2)
        minxy = corners.min(axis=1)
        maxxy = corners.max(axis=1)
        return np.concatenate([minxy, maxxy], axis=1)


class ResizeTransform(Transform):
    """Resize an (h, w) image to (new_h, new_w): pixels by PIL's bilinear
    filter, coordinates by the float32 ratio."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def apply_image(self, img):
        if img.shape[:2] == (self.new_h, self.new_w):
            return img
        from PIL import Image

        pil = Image.fromarray(img.astype(np.uint8) if img.dtype != np.uint8
                              else img)
        pil = pil.resize((self.new_w, self.new_h), Image.BILINEAR)
        return np.asarray(pil)

    def apply_coords(self, coords):
        coords = coords.astype(np.float32).copy()
        coords[:, 0] *= self.new_w / self.w
        coords[:, 1] *= self.new_h / self.h
        return coords


class ResizeShortestEdge:
    """The shortest-edge resize's target size; the augmentation that draws
    a size comes with the data path (item 10)."""

    @staticmethod
    def target_size(h: int, w: int, size: int,
                    max_size: int) -> Tuple[int, int]:
        """(new_h, new_w) with the shorter side ``size`` and the longer at
        most ``max_size``, each rounded by ``int(x + 0.5)``."""
        scale = size / min(h, w)
        if h < w:
            new_h, new_w = size, scale * w
        else:
            new_h, new_w = scale * h, size
        if max(new_h, new_w) > max_size:
            s = max_size / max(new_h, new_w)
            new_h, new_w = new_h * s, new_w * s
        return int(new_h + 0.5), int(new_w + 0.5)
