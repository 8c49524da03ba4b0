"""Instance masks (counterpart of ``drn_wsod_tpu/structures/masks.py``):
``BitMasks``, ``PolygonMasks`` and the polygon rasterizer that the mapper,
these structures and the COCO evaluator share.

The JAX package fills COCO polygons with Pillow's ``ImageDraw.polygon``.
The port must run where Pillow is not installed, so ``fill_polygon``
computes what Pillow 12's ``ImagingDrawPolygon`` computes for an 8-bit
image (``src/libImaging/Draw.c`` and ``_draw_polygon`` in
``src/_imaging.c``), step for step:

  * each vertex coordinate is truncated toward zero to an int (a C cast of
    the double), so the fill runs on integer vertices;
  * the edges are built in order, the closing edge added where the last
    vertex differs from the first; a horizontal edge that continues a
    horizontal edge in the same x direction extends it;
  * horizontal edges are drawn as spans; every other edge takes part in a
    scan over the rows from the smallest edge y (at least 0) to the largest
    (at most the height), intersected in float32 as
    ``(y - y0) * dx + x0`` with ``dx = (x1 - x0) / (y1 - y0)``;
  * at an edge's last row, above the scan's last row, the intersection is
    counted twice; at an edge's first row (or its last, on the scan's last
    row) an intersection that rounds to an earlier edge's there, where
    that edge also starts or ends at the row and continues into the
    adjacent one, is moved one pixel past both edges' intersections with
    the adjacent row where it lies more than a pixel beyond both ("connect
    discontiguous corners");
  * each row's intersections are sorted and paired; a pair fills from
    ``ROUND_UP`` of the first to ``ROUND_DOWN`` of the second, clipped to
    the image, with Pillow's float and double roundings.

``ImageDraw.polygon(..., outline=1, fill=1)`` draws no outline where the
outline's ink equals the fill's, so it fills as ``fill=1`` does. Vertex
coordinates must lie within +-2**30 (beyond, C's int arithmetic
overflows). Held bit-equal to Pillow and to the JAX package's
``rasterize_polygons`` by ``tests/test_torch_masks.py``, and to committed
digests of Pillow's masks by ``chip_smoke.py``.

``BitMasks.crop_and_resize`` resizes with ``data/transforms.py:
resize_bilinear`` (Pillow's ``resize(BILINEAR)`` on uint8, bit for bit)
where the JAX code calls Pillow.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Union

import numpy as np

_F32 = np.float32
_INT_MIN = -2 ** 31


def pillow_vertices(points) -> np.ndarray:
    """(n, 2) integer vertices as Pillow takes float coordinates: each
    double truncated toward zero (``cvttpd2dq``; NaN and values beyond the
    int32 range become INT_MIN)."""
    v = np.asarray(points, np.float64).reshape(-1, 2)
    bad = ~np.isfinite(v) | (v >= 2.0 ** 31) | (v <= -2.0 ** 31 - 1)
    return np.where(bad, _INT_MIN, np.trunc(np.where(bad, 0.0, v))).astype(
        np.int64)


def _roundf(v) -> float:
    """C ``roundf`` of a float32 value: half away from zero, exact."""
    v = float(v)
    return math.copysign(math.floor(abs(v) + 0.5), v)


def _round_up(x: np.ndarray) -> np.ndarray:
    """Pillow's ``ROUND_UP`` of float32 values: ``floor(x + 0.5F)`` with
    the sum rounded to float32 where x >= 0, ``-floor(fabs(x) + 0.5)`` in
    double otherwise."""
    pos = np.floor(x + _F32(0.5)).astype(np.float64)
    neg = -np.floor(np.abs(x).astype(np.float64) + 0.5)
    return np.where(x >= 0, pos, neg)


def _round_down(x: np.ndarray) -> np.ndarray:
    """Pillow's ``ROUND_DOWN``: ``ceil(x - 0.5F)`` (float32 difference)
    where x >= 0, ``-ceil(fabs(x) - 0.5)`` in double otherwise."""
    pos = np.ceil(x - _F32(0.5)).astype(np.float64)
    neg = -np.ceil(np.abs(x).astype(np.float64) - 0.5)
    return np.where(x >= 0, pos, neg)


class _Edge:
    __slots__ = ("x0", "y0", "xmin", "ymin", "xmax", "ymax", "dx")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.x0, self.y0 = x0, y0
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = _F32(0.0) if y0 == y1 else \
            _F32(x1 - x0) / _F32(y1 - y0)

    def at(self, y: int) -> np.float32:
        return _F32(y - self.y0) * self.dx + _F32(self.x0)


def _edges(v: np.ndarray) -> List[_Edge]:
    xs, ys = v[:, 0].tolist(), v[:, 1].tolist()
    n = len(xs)
    edges: List[_Edge] = []
    for i in range(n - 1):
        x0, y0, x1, y1 = xs[i], ys[i], xs[i + 1], ys[i + 1]
        if y0 == y1 and i != 0 and y0 == ys[i - 1]:
            # a horizontal edge continuing the previous horizontal one
            if x1 > x0 > xs[i - 1]:
                edges[-1].xmax = x1
                continue
            if x1 < x0 < xs[i - 1]:
                edges[-1].xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if xs[-1] != xs[0] or ys[-1] != ys[0]:
        edges.append(_Edge(xs[-1], ys[-1], xs[0], ys[0]))
    return edges


def _hline(canvas: np.ndarray, x0: int, y: int, x1: int) -> None:
    """Pillow's ``hline8``: the span x0..x1 of row y, clipped."""
    H, W = canvas.shape
    if 0 <= y < H and x0 < W and x1 >= 0:
        canvas[y, max(x0, 0):min(x1, W - 1) + 1] = True


def _corner(edges: List[_Edge], i: int, y: int, x: np.float32,
            adjacent: int) -> np.float32:
    """The "connect discontiguous corners" rule for edge i at row y."""
    cur = edges[i]
    one = _F32(1.0)
    for other in edges[:i]:
        if (y != other.ymin and y != other.ymax) or other.dx == 0:
            continue
        if _roundf(x) != _roundf(other.at(y)):
            continue
        if not other.ymin <= adjacent <= other.ymax:
            continue
        a, b = cur.at(adjacent), other.at(adjacent)
        if x > a + one and x > b + one:
            return _F32(_roundf(max(a, b))) + one
        if x < a - one and x < b - one:
            return _F32(_roundf(min(a, b))) - one
        return x
    return x


def fill_polygon(canvas: np.ndarray, points) -> None:
    """Fill the polygon of (n, 2) float ``points`` into the (H, W) bool
    ``canvas`` in place, as Pillow's ``draw.polygon(points, fill=1)`` fills
    an "L" image (module docstring). Raises ``TypeError`` on fewer than 2
    points, as Pillow does."""
    v = pillow_vertices(points)
    if len(v) < 2:
        raise TypeError("coordinate list must contain at least 2 coordinates")
    H, W = canvas.shape
    edges = _edges(v)
    ymin, ymax = H - 1, 0
    table = []
    for e in edges:
        ymin, ymax = min(ymin, e.ymin), max(ymax, e.ymax)
        if e.ymin == e.ymax:
            _hline(canvas, e.xmin, e.ymin, e.xmax)
        else:
            table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, H)
    last_row = min(ymax, H - 1)       # rows from H on are never drawn
    rows, xs = [], []
    for i, e in enumerate(table):
        lo, hi = max(e.ymin, ymin), min(e.ymax, last_row)
        if lo > hi:
            continue
        r = np.arange(lo, hi + 1)
        x = (r - e.y0).astype(_F32) * e.dx + _F32(e.x0)
        for k in ((0, len(r) - 1) if len(r) > 1 else (0,)):
            y = lo + k
            if y == e.ymax and y < ymax:
                rows.append(np.array([y]))
                xs.append(x[k:k + 1].copy())
            elif (y == e.ymin or y == e.ymax) and e.dx != 0:
                x[k] = _corner(table, i, y, x[k],
                               y - 1 if y == e.ymax else y + 1)
        rows.append(r)
        xs.append(x)
    if not rows:
        return
    rows = np.concatenate(rows)
    xs = np.concatenate(xs)
    order = np.lexsort((xs, rows))
    rows, xs = rows[order], xs[order]
    # rank of each intersection within its row: pairs (0, 1), (2, 3), ...
    start = np.searchsorted(rows, rows, side="left")
    rank = np.arange(len(rows)) - start
    count = np.searchsorted(rows, rows, side="right") - start
    first = (rank % 2 == 0) & (rank + 1 < count)
    idx = np.flatnonzero(first)
    x0 = _round_up(xs[idx])
    x1 = _round_down(xs[idx + 1])
    y = rows[idx]
    keep = (x0 < W) & (x1 >= 0) & (x0 <= x1)
    x0 = np.maximum(x0[keep], 0).astype(np.int64)
    x1 = np.minimum(x1[keep], W - 1).astype(np.int64)
    y = y[keep]
    if not len(y):
        return
    # spans of a row may overlap (self-intersecting polygons): count cover
    top = int(y.min())
    diff = np.zeros((int(y.max()) - top + 1, W + 1), np.int32)
    np.add.at(diff, (y - top, x0), 1)
    np.add.at(diff, (y - top, x1 + 1), -1)
    canvas[top:top + len(diff)] |= np.cumsum(diff[:, :W], axis=1) > 0


def rasterize_polygons(polys: Sequence, height: int, width: int
                       ) -> np.ndarray:
    """COCO polygon list ([x0, y0, x1, y1, ...] each) -> (H, W) bool: the
    union of the polygons of 3 or more points (fewer are skipped), each
    filled by :func:`fill_polygon`."""
    out = np.zeros((int(height), int(width)), bool)
    for p in polys or []:
        pts = np.asarray(p, np.float64).reshape(-1, 2)
        if len(pts) >= 3:
            fill_polygon(out, pts)
    return out


class BitMasks:
    """(N, H, W) boolean masks."""

    def __init__(self, tensor: np.ndarray):
        t = np.asarray(tensor)
        if t.ndim != 3:
            raise ValueError(f"BitMasks takes (N, H, W), got {t.shape}")
        self.tensor = t.astype(bool)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    @property
    def image_size(self):
        return self.tensor.shape[1:]

    def __getitem__(self, item) -> "BitMasks":
        if isinstance(item, int):
            return BitMasks(self.tensor[item:item + 1])
        return BitMasks(self.tensor[item])

    def area(self) -> np.ndarray:
        return self.tensor.reshape(len(self), -1).sum(-1).astype(np.float32)

    def nonempty(self) -> np.ndarray:
        return self.area() > 0

    def get_bounding_boxes(self) -> np.ndarray:
        """(N, 4) tight XYXY boxes, zero for an empty mask."""
        out = np.zeros((len(self), 4), np.float32)
        for i, m in enumerate(self.tensor):
            ys, xs = np.nonzero(m)
            if len(xs):
                out[i] = (xs.min(), ys.min(), xs.max() + 1, ys.max() + 1)
        return out

    def crop_and_resize(self, boxes: np.ndarray, mask_size: int) -> np.ndarray:
        """Each mask cropped to its box (floor / ceil, at least a pixel,
        clipped to the mask) and resized to (mask_size, mask_size) as
        Pillow's bilinear resize of the crop as uint8 0/255, thresholded at
        128: (N, mask_size, mask_size) bool."""
        # imported here: the data package imports this module
        from ..data.transforms import resize_bilinear

        out = np.zeros((len(self), mask_size, mask_size), bool)
        for i, (m, b) in enumerate(zip(self.tensor, boxes)):
            x1, y1, x2, y2 = b
            x1i, y1i = int(np.floor(x1)), int(np.floor(y1))
            x2i = max(int(np.ceil(x2)), x1i + 1)
            y2i = max(int(np.ceil(y2)), y1i + 1)
            H, W = m.shape
            crop = m[max(y1i, 0):min(y2i, H), max(x1i, 0):min(x2i, W)]
            if crop.size == 0:
                continue
            img = resize_bilinear(crop.astype(np.uint8) * 255, mask_size,
                                  mask_size)
            out[i] = img >= 128
        return out

    @staticmethod
    def from_polygon_masks(polygons: "PolygonMasks", height: int,
                           width: int) -> "BitMasks":
        if not len(polygons):
            return BitMasks(np.zeros((0, height, width), bool))
        return BitMasks(np.stack([rasterize_polygons(p, height, width)
                                  for p in polygons.polygons]))


class PolygonMasks:
    """Per-instance lists of COCO polygons."""

    def __init__(self, polygons: List[List[Union[np.ndarray, list]]]):
        self.polygons = [
            [np.asarray(p, np.float64).reshape(-1) for p in per_instance]
            for per_instance in polygons]

    def __len__(self) -> int:
        return len(self.polygons)

    def __getitem__(self, item) -> "PolygonMasks":
        if isinstance(item, int):
            return PolygonMasks([self.polygons[item]])
        if isinstance(item, slice):
            return PolygonMasks(self.polygons[item])
        item = np.asarray(item)
        if item.dtype == bool:
            item = np.nonzero(item)[0]
        return PolygonMasks([self.polygons[int(i)] for i in item])

    def area(self) -> np.ndarray:
        """Shoelace area summed over each instance's polygons."""
        out = []
        for per_instance in self.polygons:
            a = 0.0
            for p in per_instance:
                pts = p.reshape(-1, 2)
                x, y = pts[:, 0], pts[:, 1]
                a += 0.5 * abs(np.dot(x, np.roll(y, -1))
                               - np.dot(y, np.roll(x, -1)))
            out.append(a)
        return np.asarray(out, np.float32)

    def nonempty(self) -> np.ndarray:
        return np.asarray([len(p) > 0 for p in self.polygons])

    def get_bounding_boxes(self) -> np.ndarray:
        out = np.zeros((len(self), 4), np.float32)
        for i, per_instance in enumerate(self.polygons):
            if not per_instance:
                continue
            pts = np.concatenate([p.reshape(-1, 2) for p in per_instance])
            out[i] = (pts[:, 0].min(), pts[:, 1].min(),
                      pts[:, 0].max(), pts[:, 1].max())
        return out

    def crop_and_resize(self, boxes: np.ndarray, mask_size: int) -> np.ndarray:
        """Each instance's polygons mapped into its box at mask_size
        resolution (box sides at least 0.1) and rasterized:
        (N, mask_size, mask_size) bool."""
        out = np.zeros((len(self), mask_size, mask_size), bool)
        for i, (per_instance, b) in enumerate(zip(self.polygons, boxes)):
            if not per_instance:
                continue
            x1, y1, x2, y2 = [float(v) for v in b]
            w, h = max(x2 - x1, 0.1), max(y2 - y1, 0.1)
            scaled = []
            for p in per_instance:
                q = p.reshape(-1, 2).copy()
                q[:, 0] = (q[:, 0] - x1) * (mask_size / w)
                q[:, 1] = (q[:, 1] - y1) * (mask_size / h)
                scaled.append(q.reshape(-1))
            out[i] = rasterize_polygons(scaled, mask_size, mask_size)
        return out
