"""Frame-sequence visualisation with colours kept across frames
(counterpart of ``drn_wsod_tpu/utils/video_visualizer.py``): a detection
that overlaps one of the previous frame's (same class, IoU above a
threshold) keeps its colour, so an object reads as one track across the
clip. It works on frame arrays; the demo feeds it a sequence of image
files. Drawn by ``utils/visualizer.py``, without Pillow.
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence

import numpy as np

from .visualizer import Visualizer


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) XYXY -> (N, M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-9)).astype(np.float32)


class _Track:
    __slots__ = ("box", "cls", "color")

    def __init__(self, box, cls, color):
        self.box, self.cls, self.color = box, cls, color


class VideoVisualizer:
    """Stateful per-clip visualizer: greedy IoU matching of same-class
    detections to the previous frame's, in descending score order."""

    def __init__(self, class_names: Optional[Sequence[str]] = None,
                 iou_threshold: float = 0.5):
        self._names = class_names
        self._iou = iou_threshold
        self._tracks: List[_Track] = []
        self._rng = np.random.RandomState(0)

    def _new_color(self):
        h, s, v = self._rng.uniform(0, 1), 0.85, 0.95
        return tuple(int(c * 255) for c in colorsys.hsv_to_rgb(h, s, v))

    def draw_frame(self, frame_bgr: np.ndarray, boxes, scores, classes,
                   score_thresh: float = 0.0) -> np.ndarray:
        """The frame (BGR) with its detections drawn, as RGB."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)
        classes = np.asarray(classes, np.int64).reshape(-1)
        keep = scores >= score_thresh
        boxes, scores, classes = boxes[keep], scores[keep], classes[keep]

        prev_boxes = np.stack([t.box for t in self._tracks]) \
            if self._tracks else np.zeros((0, 4), np.float32)
        iou = _iou_matrix(boxes, prev_boxes)
        colors = [None] * len(boxes)
        used = set()
        for i in np.argsort(-scores):
            best, best_iou = -1, self._iou
            for j, t in enumerate(self._tracks):
                if j in used or t.cls != classes[i]:
                    continue
                if iou[i, j] > best_iou:
                    best, best_iou = j, iou[i, j]
            if best >= 0:
                used.add(best)
                colors[i] = self._tracks[best].color
            else:
                colors[i] = self._new_color()

        self._tracks = [_Track(boxes[i], int(classes[i]), colors[i])
                        for i in range(len(boxes))]

        vis = Visualizer(frame_bgr, self._names)
        for i in range(len(boxes)):
            self._draw_one(vis, boxes[i], int(classes[i]),
                           float(scores[i]), colors[i])
        return vis.get_image()

    @staticmethod
    def _draw_one(vis: Visualizer, box, cls: int, score: float, color):
        x1, y1, x2, y2 = [float(v) for v in box]
        vis._draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        name = vis._names[cls] if vis._names else str(cls)
        vis._draw.text((x1 + 2, max(y1 - 11, 0)),
                       f"{name} {score:.2f}", fill=color)
