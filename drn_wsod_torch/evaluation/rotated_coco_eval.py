"""COCO-style AP over rotated boxes (counterpart of
``drn_wsod_tpu/evaluation/rotated_coco_eval.py``): the COCO evaluator's
matching and AP with the exact IoU of (cx, cy, w, h, angle_deg) boxes in
place of the axis-aligned one.

The IoU is the convex-polygon intersection over union on the host, in
float64 numpy: each detection's corners clipped by each GT edge
(Sutherland-Hodgman), the area by the shoelace formula, as the JAX
package computes it, so the two agree bit for bit.
"""

from __future__ import annotations

import numpy as np

from .coco_eval import COCODetectionEvaluator


def rotated_corners_np(boxes: np.ndarray) -> np.ndarray:
    """(N, 5) -> (N, 4, 2) corners, counter-clockwise (positive shoelace
    area; the clip keeps the left side of each edge)."""
    cx, cy, w, h, a = [boxes[:, i] for i in range(5)]
    t = np.deg2rad(a)
    c, s = np.cos(t), np.sin(t)
    dx = np.stack([-w / 2, w / 2, w / 2, -w / 2], -1)     # (N, 4)
    dy = np.stack([-h / 2, -h / 2, h / 2, h / 2], -1)
    x = cx[:, None] + dx * c[:, None] - dy * s[:, None]
    y = cy[:, None] + dx * s[:, None] + dy * c[:, None]
    return np.stack([x, y], -1)


def _clip_polygon(poly, a, b):
    """The part of ``poly`` left of the segment a -> b."""
    out = []
    n = len(poly)
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        side_p = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
        side_q = (b[0] - a[0]) * (q[1] - a[1]) - (b[1] - a[1]) * (q[0] - a[0])
        if side_p >= 0:
            out.append(p)
        if (side_p >= 0) != (side_q >= 0):
            denom = side_p - side_q
            if abs(denom) > 1e-12:
                t = side_p / denom
                out.append(p + t * (q - p))
    return out


def _poly_area(poly):
    if len(poly) < 3:
        return 0.0
    p = np.asarray(poly)
    x, y = p[:, 0], p[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def iou_matrix_rotated(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(D, 5) x (G, 5) -> (D, G) exact rotated IoU, float64."""
    if len(det) == 0 or len(gt) == 0:
        return np.zeros((len(det), len(gt)))
    cd = rotated_corners_np(np.asarray(det, np.float64))
    cg = rotated_corners_np(np.asarray(gt, np.float64))
    a_d = det[:, 2] * det[:, 3]
    a_g = gt[:, 2] * gt[:, 3]
    out = np.zeros((len(det), len(gt)))
    for i in range(len(det)):
        for j in range(len(gt)):
            poly = list(cd[i])
            for k in range(4):
                poly = _clip_polygon(poly, cg[j][k], cg[j][(k + 1) % 4])
                if not poly:
                    break
            inter = _poly_area(poly)
            union = a_d[i] + a_g[j] - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out


class RotatedCOCODetectionEvaluator(COCODetectionEvaluator):
    """COCO box AP over (cx, cy, w, h, angle_deg) boxes: the detections'
    and the GT's ``bbox`` hold five numbers, areas are w * h."""

    _box_dim = 5
    _iou_fn = staticmethod(iou_matrix_rotated)

    @staticmethod
    def _box_areas(boxes: np.ndarray) -> np.ndarray:
        return boxes[:, 2] * boxes[:, 3]
