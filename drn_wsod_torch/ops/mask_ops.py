"""Mask pasting (counterpart of ``drn_wsod_tpu/ops/mask_ops.py``): each
RoI's mask probabilities resampled into the image. Host numpy, as in the
JAX package: it runs after NMS on at most ``DETECTIONS_PER_IMAGE`` masks an
image and feeds the evaluator."""

from __future__ import annotations

import numpy as np


def paste_masks_in_image(masks: np.ndarray, boxes: np.ndarray,
                         image_hw, threshold: float = 0.5) -> np.ndarray:
    """masks (N, m, m) probabilities, boxes (N, 4) XYXY in the image ->
    (N, H, W) bool. Each box's pixels (floor / ceil of the box, clipped to
    the image) sample their mask bilinearly at the pixel centre, clamped
    to the mask's cells, and keep those at or above ``threshold``; the
    arithmetic is the JAX package's, in the same order."""
    H, W = int(image_hw[0]), int(image_hw[1])
    N, m, _ = masks.shape
    out = np.zeros((N, H, W), dtype=bool)
    for i in range(N):
        x1, y1, x2, y2 = boxes[i]
        x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
        x2i, y2i = int(np.ceil(x2)), int(np.ceil(y2))
        x1i, y1i = max(x1i, 0), max(y1i, 0)
        x2i, y2i = min(x2i, W), min(y2i, H)
        w, h = x2i - x1i, y2i - y1i
        if w <= 0 or h <= 0:
            continue
        ys = (np.arange(h) + 0.5 + (y1i - y1)) / max(y2 - y1, 1e-6) * m - 0.5
        xs = (np.arange(w) + 0.5 + (x1i - x1)) / max(x2 - x1, 1e-6) * m - 0.5
        ys = np.clip(ys, 0, m - 1)
        xs = np.clip(xs, 0, m - 1)
        y0 = np.floor(ys).astype(int)
        y1_ = np.minimum(y0 + 1, m - 1)
        x0 = np.floor(xs).astype(int)
        x1_ = np.minimum(x0 + 1, m - 1)
        wy = (ys - y0)[:, None]
        wx = (xs - x0)[None, :]
        mk = masks[i]
        interp = (mk[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
                  + mk[np.ix_(y0, x1_)] * (1 - wy) * wx
                  + mk[np.ix_(y1_, x0)] * wy * (1 - wx)
                  + mk[np.ix_(y1_, x1_)] * wy * wx)
        out[i, y1i:y2i, x1i:x2i] = interp >= threshold
    return out
