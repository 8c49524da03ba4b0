"""Detection visualisation in numpy, without Pillow (counterpart of
``drn_wsod_tpu/utils/visualizer.py``, which draws through ``ImageDraw``).

:class:`Visualizer` draws into a uint8 RGB array with the pixel rules of
Pillow 12's ``ImageDraw``, which the JAX package's visualizer uses:

  * every coordinate of a shape is truncated toward zero to an int first
    (``_imaging.c``), and a rectangle or ellipse whose second corner lies
    before its first raises ``ValueError``;
  * ``rectangle(width=w)``: w rows at the top and bottom, w columns at each
    side between them (``Draw.c:ImagingDrawRectangle``);
  * ``line`` and the polygon outline: Bresenham segments without their end
    point (``Draw.c:line32``); ``line`` then sets its last point, the
    outline closes on its first vertex;
  * the filled ``ellipse``: the spans of Pillow's quarter-ellipse walk
    (``Draw.c:quarter_next``, ``ellipse_next``) on the truncated box;
  * ``text`` with the default font (FreeType Aileron Regular at size 10):
    the glyphs of ``font_table.json`` (``tools/make_font_fixtures.py``)
    placed at whole-pixel advances, overlaps merged as ``t + s -
    DIV255(t s)``, then blended into the image as ``DIV255(in (255 - m) +
    ink m)`` (Pillow's ``fill_mask_L``). Pillow renders a label whose origin
    has a fractional part at that sub-pixel offset; the port draws it at
    the truncated origin, so such labels may differ from Pillow's inside
    their text box, and nowhere else.

The mask and semantic-segmentation blends are the JAX package's float32
numpy code, truncated by ``astype(uint8)``. :meth:`Visualizer.save` writes
PNG (``data/png.py:write_png``) or JPEG (``native.py:jpeg_encode``, the
bytes of Pillow's default ``save``) by the file's extension; any other
extension raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import colorsys
import functools
import json
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

FONT_TABLE = Path(__file__).resolve().parent / "font_table.json"


def _class_colors(n: int):
    return [tuple(int(c * 255) for c in colorsys.hsv_to_rgb(i / max(n, 1),
                                                            0.85, 0.95))
            for i in range(n)]


# COCO person skeleton (17-keypoint connectivity, reference
# detectron2/data/datasets/builtin_meta.py keypoint_connection_rules).
COCO_PERSON_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]


def _mask_contour(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a boolean mask: mask minus its 4-neighbour
    erosion."""
    m = np.asarray(mask, bool)
    if not m.any():
        return m
    er = m.copy()
    er[1:, :] &= m[:-1, :]
    er[:-1, :] &= m[1:, :]
    er[:, 1:] &= m[:, :-1]
    er[:, :-1] &= m[:, 1:]
    return m & ~er


def _div255(a: np.ndarray) -> np.ndarray:
    t = a + 128
    return ((t >> 8) + t) >> 8


@functools.lru_cache(maxsize=None)
def font_table() -> Tuple[dict, dict]:
    """{char: (coverage (h, w) uint8, (dx, dy), advance)} and the kerning
    {(a, b): pixels} of the default font, from ``font_table.json``."""
    raw = json.loads(FONT_TABLE.read_text())
    glyphs = {}
    for code, g in raw["glyphs"].items():
        rows = [np.frombuffer(bytes.fromhex(r), np.uint8) for r in g["rows"]]
        mask = (np.stack(rows) if rows
                else np.zeros((0, g["width"]), np.uint8))
        glyphs[chr(int(code))] = (mask, tuple(g["offset"]), g["advance"])
    kerning = {tuple(chr(int(c)) for c in k.split(",")): int(v)
               for k, v in raw["kerning"].items()}
    return glyphs, kerning


def render_text(text: str) -> Tuple[np.ndarray, int, int]:
    """The coverage of ``text`` drawn at origin (0, 0): (mask (h, w) uint8,
    left, top), the mask's top-left pixel relative to the origin. A
    character outside printable ASCII raises ``KeyError``."""
    glyphs, kerning = font_table()
    placed, pen = [], 0
    for i, ch in enumerate(text):
        mask, (dx, dy), adv = glyphs[ch]
        placed.append((mask, pen + dx, dy))
        pen += adv + (kerning.get((ch, text[i + 1]), 0)
                      if i + 1 < len(text) else 0)
    placed = [p for p in placed if p[0].size]
    if not placed:
        return np.zeros((0, 0), np.uint8), 0, 0
    left = min(x for _, x, _ in placed)
    top = min(y for _, _, y in placed)
    right = max(x + m.shape[1] for m, x, _ in placed)
    bottom = max(y + m.shape[0] for m, _, y in placed)
    out = np.zeros((bottom - top, right - left), np.int32)
    for m, x, y in placed:
        sub = out[y - top:y - top + m.shape[0], x - left:x - left + m.shape[1]]
        s = m.astype(np.int32)
        sub[...] = sub + s - _div255(sub * s)
    return out.astype(np.uint8), left, top


def _trunc(v) -> int:
    return int(float(v))


class Canvas:
    """A uint8 RGB image and Pillow's drawing rules on it (module
    docstring); colours are RGB tuples, set, not blended."""

    def __init__(self, rgb: np.ndarray):
        self.img = rgb

    def _hline(self, x0: int, y: int, x1: int, color) -> None:
        h, w = self.img.shape[:2]
        if not 0 <= y < h:
            return
        if x0 > x1:
            x0, x1 = x1, x0
        if x0 < 0:
            x0 = 0
        elif x0 >= w:
            return
        if x1 < 0:
            return
        x1 = min(x1, w - 1)
        if x0 <= x1:
            self.img[y, x0:x1 + 1] = color

    def _point(self, x: int, y: int, color) -> None:
        h, w = self.img.shape[:2]
        if 0 <= x < w and 0 <= y < h:
            self.img[y, x] = color

    def _line(self, x0: int, y0: int, x1: int, y1: int, color) -> None:
        """Bresenham from (x0, y0) toward (x1, y1), the end excluded."""
        dx, xs = (x0 - x1, -1) if x1 < x0 else (x1 - x0, 1)
        dy, ys = (y0 - y1, -1) if y1 < y0 else (y1 - y0, 1)
        if dx == 0 or dy == 0:
            n = dy if dx == 0 else dx
            for _ in range(n):
                self._point(x0, y0, color)
                x0 += xs if dy == 0 else 0
                y0 += ys if dx == 0 else 0
        elif dx > dy:
            n, dy, e, dx = dx, 2 * dy, 2 * dy - dx, 2 * dx
            for _ in range(n):
                self._point(x0, y0, color)
                if e >= 0:
                    y0 += ys
                    e -= dx
                e += dy
                x0 += xs
        else:
            n, dx, e, dy = dy, 2 * dx, 2 * dx - dy, 2 * dy
            for _ in range(n):
                self._point(x0, y0, color)
                if e >= 0:
                    x0 += xs
                    e -= dy
                e += dx
                y0 += ys

    @staticmethod
    def _box(xy) -> Tuple[int, int, int, int]:
        x0, y0, x1, y1 = (float(v) for v in xy)
        if x1 < x0:
            raise ValueError("x1 must be greater than or equal to x0")
        if y1 < y0:
            raise ValueError("y1 must be greater than or equal to y0")
        return _trunc(x0), _trunc(y0), _trunc(x1), _trunc(y1)

    def rectangle(self, xy, outline, width: int = 1) -> None:
        x0, y0, x1, y1 = self._box(xy)
        for i in range(max(width, 1)):
            self._hline(x0, y0 + i, x1, outline)
            self._hline(x0, y1 - i, x1, outline)
            self._line(x1 - i, y0 + width, x1 - i, y1 - width + 1, outline)
            self._line(x0 + i, y0 + width, x0 + i, y1 - width + 1, outline)

    def line(self, points, fill) -> None:
        """``ImageDraw.line(points, fill, width=1)``."""
        pts = [(_trunc(x), _trunc(y)) for x, y in points]
        for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
            self._line(x0, y0, x1, y1, fill)
        if len(pts) > 1:
            self._point(*pts[-1], fill)

    def polygon(self, points, outline) -> None:
        """``ImageDraw.polygon(points, outline=outline)``."""
        pts = [(_trunc(x), _trunc(y)) for x, y in points]
        if len(pts) < 2:
            return
        for i in range(len(pts)):
            (x0, y0), (x1, y1) = pts[i], pts[(i + 1) % len(pts)]
            self._line(x0, y0, x1, y1, outline)

    def ellipse(self, xy, fill) -> None:
        """``ImageDraw.ellipse(xy, fill=fill)``."""
        x0, y0, x1, y1 = self._box(xy)
        a, b = x1 - x0, y1 - y0
        for sx0, sy, sx1 in _ellipse_spans(a, b):
            self._hline(x0 + (sx0 + a) // 2, y0 + (sy + b) // 2,
                        x0 + (sx1 + a) // 2, fill)

    def text(self, xy, text: str, fill) -> None:
        """``ImageDraw.text(xy, text, fill)`` with the default font, at the
        truncated origin."""
        mask, left, top = render_text(text)
        if not mask.size:
            return
        h, w = self.img.shape[:2]
        x = _trunc(xy[0]) + left
        y = _trunc(xy[1]) + top
        ys, xs = max(y, 0), max(x, 0)
        ye, xe = min(y + mask.shape[0], h), min(x + mask.shape[1], w)
        if ys >= ye or xs >= xe:
            return
        m = mask[ys - y:ye - y, xs - x:xe - x].astype(np.int32)[..., None]
        region = self.img[ys:ye, xs:xe].astype(np.int32)
        ink = np.asarray(fill, np.int32)
        self.img[ys:ye, xs:xe] = _div255(region * (255 - m) + ink * m) \
            .astype(np.uint8)


def _quarter(a: int, b: int):
    """Pillow's quarter-ellipse walk (``Draw.c:quarter_next``) in doubled
    coordinates, from (a, b % 2) to (a % 2, b)."""
    if a < 0 or b < 0:
        return
    a2, b2 = a * a, b * b
    a2b2 = a2 * b2

    def delta(x, y):
        return abs(a2 * y * y + b2 * x * x - a2b2)

    cx, cy, ex, ey = a, b % 2, a % 2, b
    while True:
        yield cx, cy
        if cx == ex and cy == ey:
            return
        nx, ny = cx, cy + 2
        nd = delta(nx, ny)
        if nx > 1:
            d = delta(cx - 2, cy + 2)
            if nd > d:
                nx, ny, nd = cx - 2, cy + 2, d
            d = delta(cx - 2, cy)
            if nd > d:
                nx, ny = cx - 2, cy
        cx, cy = nx, ny


def _ellipse_spans(a: int, b: int):
    """(x0, y, x1) spans of a filled ellipse of doubled axes a, b
    (``Draw.c:ellipse_init`` / ``ellipse_next`` with width a + b)."""
    outer = _quarter(a, b)
    first = next(outer, None)
    if first is None:
        return
    pr, py = first
    leftmost = a % 2
    finished = False
    while not finished:
        y, l, r = py, leftmost, pr
        nxt = None
        for cx, cy in outer:
            if cy > y:
                nxt = (cx, cy)
                break
        if nxt is None:
            finished = True
        else:
            pr, py = nxt
        spans = []
        if (l > 0 or l < r) and y > 0:
            spans.append((2 if l == 0 else l, y, r))
        if y > 0:
            spans.append((-r, y, -l))
        if l > 0 or l < r:
            spans.append((2 if l == 0 else l, -y, r))
        spans.append((-r, -y, -l))
        yield from reversed(spans)


class Visualizer:
    def __init__(self, image_bgr: np.ndarray,
                 class_names: Optional[Sequence[str]] = None):
        """image_bgr: (H, W, 3) uint8 in BGR (pipeline order)."""
        self._img = np.ascontiguousarray(image_bgr[:, :, ::-1]) \
            .astype(np.uint8)
        self._draw = Canvas(self._img)
        self._names = list(class_names) if class_names else None
        self._colors = _class_colors(len(self._names) if self._names else 80)

    def _set_image(self, rgb: np.ndarray) -> None:
        self._img = rgb
        self._draw = Canvas(rgb)

    def draw_instance_predictions(self, boxes, scores, classes, valid=None,
                                  score_thresh: float = 0.0, masks=None,
                                  keypoints=None):
        """Draw detections; optional (N, H, W) bool masks and (N, K, 3)
        keypoints."""
        for i in range(len(scores)):
            if valid is not None and not valid[i]:
                continue
            if scores[i] < score_thresh:
                continue
            cid = int(classes[i])
            self.draw_box(boxes[i], cid, float(scores[i]))
            if masks is not None:
                self.draw_mask(masks[i], cid)
            if keypoints is not None:
                self.draw_keypoints(keypoints[i], cid)
        return self

    def draw_mask(self, mask, class_id: int = 0, alpha: float = 0.45,
                  color=None, outline: bool = True):
        """Alpha-blend a boolean (H, W) mask in the class colour, with a
        solid boundary contour."""
        if color is None:
            color = self._colors[class_id % len(self._colors)]
        base = self._img.astype(np.float32)
        m = np.asarray(mask, bool)
        over = np.asarray(color, np.float32)
        base[m] = (1 - alpha) * base[m] + alpha * over
        if outline:
            base[_mask_contour(m)] = over
        self._set_image(base.astype(np.uint8))
        return self

    def draw_keypoints(self, kpts, class_id: int = 0, radius: int = 2,
                       skeleton=None):
        """(K, 3) keypoints; visibility > 0 drawn as dots, ``skeleton``
        pairs as lines (the COCO person skeleton when K == 17)."""
        color = self._colors[class_id % len(self._colors)]
        kpts = np.asarray(kpts)
        if skeleton is None and len(kpts) == 17:
            skeleton = COCO_PERSON_SKELETON
        for i, j in (skeleton or ()):
            if i < len(kpts) and j < len(kpts) \
                    and kpts[i, 2] > 0 and kpts[j, 2] > 0:
                self._draw.line([tuple(kpts[i, :2]), tuple(kpts[j, :2])],
                                fill=color)
        for x, y, v in kpts:
            if v > 0:
                self._draw.ellipse([x - radius, y - radius,
                                    x + radius, y + radius], fill=color)
        return self

    def draw_rotated_box(self, box5, class_id: int = 0,
                         score: Optional[float] = None):
        """5-param rotated box (cx, cy, w, h, angle in degrees CCW), the
        ``structures/rotated_boxes.py`` convention."""
        color = self._colors[class_id % len(self._colors)]
        cx, cy, w, h, a = [float(v) for v in box5]
        t = np.deg2rad(a)
        c, s = np.cos(t), np.sin(t)
        # y grows downward, so CCW angle rotates with -sin in image coords
        pts = [(cx + c * dx + s * dy, cy - s * dx + c * dy)
               for dx, dy in ((-w / 2, -h / 2), (w / 2, -h / 2),
                              (w / 2, h / 2), (-w / 2, h / 2))]
        self._draw.polygon(pts, outline=color)
        if self._names or score is not None:
            name = self._names[class_id] if self._names else str(class_id)
            label = f"{name} {score:.2f}" if score is not None else name
            x0, y0 = pts[0]
            self._draw.text((x0 + 2, max(y0 - 11, 0)), label, fill=color)
        return self

    def draw_panoptic_seg(self, panoptic_map, segments_info,
                          alpha: float = 0.45):
        """(H, W) segment-id map + list of {"id", "category_id",
        "isthing"} dicts: stuff segments in the class colour, thing
        segments in a jittered colour each, labels at the centroids."""
        pan = np.asarray(panoptic_map)
        rng = np.random.RandomState(0)
        for info in segments_info:
            m = pan == info["id"]
            if not m.any():
                continue
            cid = int(info.get("category_id", 0))
            color = np.asarray(self._colors[cid % len(self._colors)],
                               np.float32)
            if info.get("isthing", False):
                color = np.clip(color + rng.uniform(-40, 40, 3), 0, 255)
            self.draw_mask(m, cid, alpha=alpha,
                           color=tuple(int(v) for v in color))
            if self._names and cid < len(self._names):
                ys, xs = np.nonzero(m)
                self._draw.text((float(xs.mean()), float(ys.mean())),
                                self._names[cid],
                                fill=tuple(int(v) for v in color))
        return self

    def draw_dataset_dict(self, record):
        """Draw ground truth from a dataset-dict record's annotations
        (boxes, polygon outlines, keypoints) and its ``sem_seg``."""
        for ann in record.get("annotations", ()):
            cid = int(ann.get("category_id", 0))
            if "bbox" in ann:
                x, y, w, h = ann["bbox"]
                # dataset dicts carry XYWH unless bbox_mode says otherwise
                if ann.get("bbox_mode", "xywh") in ("xywh", 1):
                    box = (x, y, x + w, y + h)
                else:
                    box = (x, y, w, h)
                self.draw_box(box, cid)
            seg = ann.get("segmentation")
            if isinstance(seg, list):
                for poly in seg:
                    pts = np.asarray(poly, np.float32).reshape(-1, 2)
                    self._draw.polygon(
                        [tuple(p) for p in pts],
                        outline=self._colors[cid % len(self._colors)])
            if "keypoints" in ann:
                self.draw_keypoints(
                    np.asarray(ann["keypoints"], np.float32).reshape(-1, 3),
                    cid)
        if "sem_seg" in record:
            self.draw_sem_seg(record["sem_seg"])
        return self

    def draw_sem_seg(self, seg, alpha: float = 0.45, ignore: int = 255):
        """(H, W) int class map alpha-blended with per-class colours."""
        seg = np.asarray(seg)
        base = self._img.astype(np.float32)
        for c in np.unique(seg):
            if c == ignore:
                continue
            m = seg == c
            over = np.asarray(self._colors[int(c) % len(self._colors)],
                              np.float32)
            base[m] = (1 - alpha) * base[m] + alpha * over
        self._set_image(base.astype(np.uint8))
        return self

    def draw_box(self, box, class_id: Optional[int] = 0,
                 score: Optional[float] = None):
        """``class_id=None`` draws an unlabeled neutral-colour box (raw
        proposals); ids outside the name table are labelled by number."""
        if class_id is None:
            color = (180, 180, 180)
        else:
            color = self._colors[class_id % len(self._colors)]
        x1, y1, x2, y2 = [float(v) for v in box]
        self._draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        if class_id is not None and (self._names or score is not None):
            name = (self._names[class_id]
                    if self._names and 0 <= class_id < len(self._names)
                    else str(class_id))
            label = f"{name} {score:.2f}" if score is not None else name
            self._draw.text((x1 + 2, max(y1 - 11, 0)), label, fill=color)
        return self

    def get_image(self) -> np.ndarray:
        return self._img

    def save(self, path: str):
        save_image(path, self._img)


def save_image(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as PNG or JPEG by ``path``'s
    extension (``.png``; ``.jpg``, ``.jpeg``); another extension raises
    ``ValueError`` naming the file."""
    from ..data.png import encode_png
    from ..native import jpeg_encode

    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = encode_png(rgb)
    elif ext in (".jpg", ".jpeg"):
        data = jpeg_encode(rgb)
    else:
        raise ValueError(f"cannot save {path!r}: the port writes PNG "
                         f"(.png) and JPEG (.jpg, .jpeg) only, not "
                         f"{ext!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def save_pgt_visualization(image_bgr, pgt_boxes, pgt_valid, class_names,
                           out_dir: str, prefix: str, suffix: str):
    """Dump mined pseudo-GT boxes for inspection as
    ``out_dir/{prefix}{suffix}.png``."""
    v = Visualizer(image_bgr, class_names)
    for c in range(len(pgt_valid)):
        if pgt_valid[c]:
            v.draw_box(pgt_boxes[c], c)
    v.save(os.path.join(out_dir, f"{prefix}{suffix}.png"))
