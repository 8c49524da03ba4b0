"""Host-side image and box transforms and the random augmentations of the
data path (counterpart of ``drn_wsod_tpu/data/transforms.py``): the
deterministic transforms (no-op, list, resize, horizontal flip, crop, blend,
extent, rotation), the augmentations that draw them from a
``np.random.RandomState`` (shortest-edge resize, flip, crop, rotation,
extent, brightness, contrast, saturation, lighting) and
``apply_augmentations``.

The port resamples without Pillow, which the GPU machines it trains on may
lack, and computes what Pillow computes: the resize is Pillow's
``Image.resize(..., BILINEAR)`` on uint8, bit for bit (``resize_bilinear``),
and a label map's resize is Pillow's ``NEAREST`` (``resize_nearest``); the
extent and the rotation are Pillow's ``Image.transform`` affine sampler
(``Geometry.c``) and ``Image.rotate``'s canvas rule (``affine_resample``,
``rotate_like_pillow``), as the JAX package's transforms call them.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

# Pillow's fixed-point precision for 8-bit resampling (Resample.c)
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coeffs(in_size: int, out_size: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for the triangle filter, then
    ``normalize_coeffs_8bpc``: each output index's first input index
    ``xmin`` (out,) and its fixed-point tap weights (out, ksize) int32,
    zero past the index's last tap."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale                     # the triangle's support is 1
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) truncates toward 0; the operands are >= -0.5 here, and
    # truncating -0.5 < v < 0 gives 0, as the clamp below does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    taps = np.arange(ksize)
    x = np.abs((taps[None, :] + xmin[:, None] - center[:, None] + 0.5)
               * (1.0 / filterscale))
    w = np.where(x < 1.0, 1.0 - x, 0.0)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    # round half away from zero, then truncate (the weights are >= 0)
    k = np.trunc(np.where(w < 0, w * (1 << _PRECISION_BITS) - 0.5,
                          w * (1 << _PRECISION_BITS) + 0.5))
    return xmin, k.astype(np.int32)


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One separable pass of Pillow's 8-bit bilinear resample along
    ``axis``: each sum starts at half a unit, is shifted right by the
    precision and clipped to [0, 255]."""
    in_size = img.shape[axis]
    xmin, k = _bilinear_coeffs(in_size, out_size)
    kshape = (out_size,) + (1,) * (img.ndim - 1 - axis)
    acc = tmp = None
    for t in range(k.shape[1]):
        kt = k[:, t]
        if not kt.any():
            continue
        src = np.take(img, np.minimum(xmin + t, in_size - 1), axis=axis)
        if acc is None:
            acc = np.multiply(src, kt.reshape(kshape), dtype=np.int32)
            tmp = np.empty_like(acc)
        else:
            np.multiply(src, kt.reshape(kshape), out=tmp, dtype=np.int32)
            acc += tmp
    acc += 1 << (_PRECISION_BITS - 1)
    acc >>= _PRECISION_BITS
    np.clip(acc, 0, 255, out=acc)
    return acc.astype(np.uint8)


def resize_bilinear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Resize an (H, W) or (H, W, C) uint8 image to (new_h, new_w) exactly
    as Pillow's ``Image.resize((new_w, new_h), Image.BILINEAR)`` does
    (``ImagingResample`` in ``src/libImaging/Resample.c``): a horizontal
    pass, then a vertical one over its uint8 result, each skipped where
    that side is unchanged; per axis ``scale = in / out``, the filter
    widened by ``max(scale, 1)``, tap centres at ``(i + 0.5) * scale``,
    weights normalised to sum 1 and rounded to 22 fractional bits. The
    channels are independent, so BGR and RGB give the same result. Held
    bit-equal to Pillow by ``tests/test_torch_train_data.py``; where this
    description and Pillow's output disagree, Pillow's output is the
    reference."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = img.astype(np.uint8)
    if img.shape[1] != new_w:
        img = _resample_axis(img, 1, new_w)
    if img.shape[0] != new_h:
        img = _resample_axis(img, 0, new_h)
    return img


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each of ``n_out`` outputs in Pillow's NEAREST
    resize (``ImagingScaleAffine``): the position starts at ``a / 2``,
    ``a = n_in / n_out`` in double, and adds ``a`` in double once per
    output; each is truncated to int. (``floor((i + 0.5) * a)`` differs
    from it on about a quarter of size pairs.)"""
    a = n_in / n_out
    pos = np.add.accumulate(np.concatenate([[a * 0.5],
                                            np.full(n_out - 1, a)]))
    return np.minimum(pos.astype(np.int64), n_in - 1)


def resize_nearest(seg: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """An (H, W) label map (any dtype) resized to (new_h, new_w) as
    Pillow's ``Image.fromarray(seg).resize((new_w, new_h), NEAREST)``."""
    h, w = seg.shape[:2]
    return seg[np.ix_(_nearest_index(h, new_h), _nearest_index(w, new_w))]


def _coord(v: np.ndarray) -> np.ndarray:
    """Geometry.c's ``COORD``: -1 below 0, else truncation to int."""
    return np.where(v < 0.0, -1, np.trunc(np.maximum(v, 0.0))).astype(
        np.int64)


def affine_resample(img: np.ndarray, out_w: int, out_h: int,
                    a: Sequence[float], bilinear: bool) -> np.ndarray:
    """``Image.transform((out_w, out_h), AFFINE, a, BILINEAR or NEAREST)``
    of an (H, W) or (H, W, C) array, as Pillow's ``Geometry.c`` computes
    it in float64; pixels that map outside the input are 0.

    Output pixel (x, y) reads input point ``(a0 (x+.5) + a1 (y+.5) + a2,
    a3 (x+.5) + a4 (y+.5) + a5)``. Bilinear (``ImagingGenericTransform``,
    ``bilinear_filter8``/``32RGB``) leaves out points outside [0, W) x
    [0, H), samples at (x-.5, y-.5) between the clipped neighbours and
    truncates to the dtype. Nearest is ``ImagingScaleAffine`` where a1 =
    a3 = 0, else ``ImagingTransformAffine``: in 16.16 fixed point
    (``affine_fixed``) where the corners map within 32768, else in
    float64; the float loops step their coordinates by repeated addition,
    as the C loops do, and truncate them."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    a = [float(v) for v in a]
    out = np.zeros((out_h, out_w) + img.shape[2:], img.dtype)
    if out_w <= 0 or out_h <= 0:
        return out
    if bilinear:
        xs = np.arange(out_w, dtype=np.float64)[None, :] + 0.5
        ys = np.arange(out_h, dtype=np.float64)[:, None] + 0.5
        xin = a[0] * xs + a[1] * ys + a[2]
        yin = a[3] * xs + a[4] * ys + a[5]
        valid = (xin >= 0.0) & (xin < W) & (yin >= 0.0) & (yin < H)
        xin = xin - 0.5
        yin = yin - 0.5
        xf = np.floor(xin)
        yf = np.floor(yin)
        dx = xin - xf
        dy = yin - yf
        x = xf.astype(np.int64)
        y = yf.astype(np.int64)
        x0 = np.clip(x, 0, W - 1)
        x1 = np.clip(x + 1, 0, W - 1)
        y0 = np.clip(y, 0, H - 1)
        y1ok = (y + 1 >= 0) & (y + 1 < H)
        y1 = np.clip(y + 1, 0, H - 1)
        if img.ndim == 3:
            dx, dy, y1ok = dx[..., None], dy[..., None], y1ok[..., None]
        src = img.astype(np.float64)
        a0, b0 = src[y0, x0], src[y0, x1]
        v1 = a0 + (b0 - a0) * dx
        a1, b1 = src[y1, x0], src[y1, x1]
        v2 = np.where(y1ok, a1 + (b1 - a1) * dx, v1)
        v = v1 + (v2 - v1) * dy
        mask = valid[..., None] if img.ndim == 3 else valid
        out[...] = np.where(mask, v, 0).astype(img.dtype)
        return out
    if a[1] == 0 and a[3] == 0:
        xo = np.add.accumulate(np.r_[a[2] + a[0] * 0.5,
                                     np.full(out_w - 1, a[0])])
        yo = np.add.accumulate(np.r_[a[5] + a[4] * 0.5,
                                     np.full(out_h - 1, a[4])])
        xi, yi = _coord(xo), _coord(yo)
        okx = (xi >= 0) & (xi < W)
        oky = (yi >= 0) & (yi < H)
        rows = np.nonzero(oky)[0]
        cols = np.nonzero(okx)[0]
        out[np.ix_(rows, cols)] = img[np.ix_(yi[rows], xi[cols])]
        return out
    if all(abs(x * a[0] + y * a[1] + a[2]) < 32768.0
           and abs(x * a[3] + y * a[4] + a[5]) < 32768.0
           for x, y in ((0, 0), (out_w, out_h), (0, out_h), (out_w, 0))):
        # affine_fixed: 16.16 fixed point, FIX(v) = FLOOR(v * 65536 + .5)
        def fix(v):
            return math.floor(v * 65536.0 + 0.5)

        a0, a1, a3, a4 = fix(a[0]), fix(a[1]), fix(a[3]), fix(a[4])
        a2 = fix(a[2] + a[0] * 0.5 + a[1] * 0.5)
        a5 = fix(a[5] + a[3] * 0.5 + a[4] * 0.5)
        xs = np.arange(out_w, dtype=np.int64)[None, :]
        ys = np.arange(out_h, dtype=np.int64)[:, None]
        xi = (a2 + ys * a1 + xs * a0) >> 16
        yi = (a5 + ys * a4 + xs * a3) >> 16
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out[ok] = img[yi[ok], xi[ok]]
        return out
    xo = np.add.accumulate(np.r_[a[2] + a[1] * 0.5 + a[0] * 0.5,
                                 np.full(out_h - 1, a[1])])
    yo = np.add.accumulate(np.r_[a[5] + a[4] * 0.5 + a[3] * 0.5,
                                 np.full(out_h - 1, a[4])])
    xx = np.add.accumulate(np.concatenate(
        [xo[:, None], np.full((out_h, out_w - 1), a[0])], axis=1), axis=1)
    yy = np.add.accumulate(np.concatenate(
        [yo[:, None], np.full((out_h, out_w - 1), a[3])], axis=1), axis=1)
    xi, yi = _coord(xx), _coord(yy)
    ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    out[ok] = img[yi[ok], xi[ok]]
    return out


def rotate_like_pillow(img: np.ndarray, angle: float, bilinear: bool,
                       expand: bool = True) -> np.ndarray:
    """``Image.rotate(angle, BILINEAR or NEAREST, expand)`` about the
    centre (``PIL/Image.py``): the right-angle transposes, else the
    inverse rotation matrix rounded to 15 places, the canvas
    ``ceil(max) - floor(min)`` of the rotated corners when ``expand``,
    and :func:`affine_resample`."""
    img = np.asarray(img)
    angle = angle % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and (expand or w == h):
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    center = (w / 2, h / 2)
    rad = -math.radians(angle)
    matrix = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
              round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]

    def transform(x, y, m):
        (a, b, c, d, e, f) = m
        return a * x + b * y + c, d * x + e * y + f

    matrix[2], matrix[5] = transform(-center[0], -center[1], matrix)
    matrix[2] += center[0]
    matrix[5] += center[1]
    if expand:
        xx, yy = zip(*(transform(x, y, matrix)
                       for x, y in ((0, 0), (w, 0), (w, h), (0, h))))
        nw = math.ceil(max(xx)) - math.floor(min(xx))
        nh = math.ceil(max(yy)) - math.floor(min(yy))
        matrix[2], matrix[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0,
                                         matrix)
        w, h = nw, nh
    return affine_resample(img, w, h, matrix, bilinear)


class Transform:
    """A deterministic transform of images and of XYXY boxes."""

    def output_size(self, hw):
        """(h, w) -> the transformed (h, w), without touching pixels (lets
        the mapper plan size buckets from record metadata)."""
        return hw

    def apply_image(self, img: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def apply_segmentation(self, seg: np.ndarray) -> np.ndarray:
        """A label map goes through ``apply_image``; the transforms that
        interpolate override it with nearest sampling."""
        return self.apply_image(seg)

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

    def inverse(self) -> "Transform":
        raise NotImplementedError


class NoOpTransform(Transform):
    def apply_image(self, img):
        return img

    def apply_coords(self, coords):
        return coords

    def inverse(self):
        return self


class TransformList(Transform):
    """Transforms applied in order."""

    def __init__(self, tfms: Sequence[Transform]):
        self.transforms: List[Transform] = list(tfms)

    def output_size(self, hw):
        for t in self.transforms:
            hw = t.output_size(hw)
        return hw

    def apply_image(self, img):
        for t in self.transforms:
            img = t.apply_image(img)
        return img

    def apply_coords(self, coords):
        for t in self.transforms:
            coords = t.apply_coords(coords)
        return coords

    def apply_segmentation(self, seg):
        for t in self.transforms:
            seg = t.apply_segmentation(seg)
        return seg

    def inverse(self):
        return TransformList([t.inverse() for t in reversed(self.transforms)])

    def __add__(self, other: Transform) -> "TransformList":
        others = (other.transforms if isinstance(other, TransformList)
                  else [other])
        return TransformList(self.transforms + list(others))


class ResizeTransform(Transform):
    """Resize an (h, w) image to (new_h, new_w): pixels by
    :func:`resize_bilinear` (Pillow's bilinear filter), label maps by
    :func:`resize_nearest`, coordinates by the float32 ratio."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def output_size(self, hw):
        return (self.new_h, self.new_w)

    def apply_image(self, img):
        if img.shape[:2] == (self.new_h, self.new_w):
            return img
        return resize_bilinear(img, self.new_h, self.new_w)

    def apply_segmentation(self, seg):
        """Nearest sampling, Pillow's (:func:`resize_nearest`)."""
        if seg.shape[:2] == (self.new_h, self.new_w):
            return seg
        return resize_nearest(seg, self.new_h, self.new_w)

    def apply_coords(self, coords):
        coords = coords.astype(np.float32).copy()
        coords[:, 0] *= self.new_w / self.w
        coords[:, 1] *= self.new_h / self.h
        return coords

    def inverse(self):
        return ResizeTransform(self.new_h, self.new_w, self.h, self.w)


class HFlipTransform(Transform):
    def __init__(self, width: int):
        self.width = width

    def apply_image(self, img):
        return np.ascontiguousarray(img[:, ::-1])

    def apply_coords(self, coords):
        coords = coords.astype(np.float32).copy()
        coords[:, 0] = self.width - coords[:, 0]
        return coords

    def inverse(self):
        return self


class CropTransform(Transform):
    def __init__(self, x0: int, y0: int, w: int, h: int,
                 orig_w: int = 0, orig_h: int = 0):
        self.x0, self.y0, self.w, self.h = x0, y0, w, h
        self.orig_w, self.orig_h = orig_w, orig_h

    def output_size(self, hw):
        return (self.h, self.w)

    def apply_image(self, img):
        return img[self.y0:self.y0 + self.h, self.x0:self.x0 + self.w]

    def apply_coords(self, coords):
        coords = coords.astype(np.float32).copy()
        coords[:, 0] -= self.x0
        coords[:, 1] -= self.y0
        return coords

    def inverse(self):
        raise NotImplementedError("a crop has no inverse (train only)")


class BlendTransform(Transform):
    """The photometric blend ``src_weight * src_image + dst_weight * img``
    in float32, clipped back to an integer image's dtype; geometry and
    label maps are untouched."""

    def __init__(self, src_image, src_weight: float, dst_weight: float):
        self.src_image = src_image
        self.src_weight = src_weight
        self.dst_weight = dst_weight

    def apply_image(self, img):
        out = self.src_weight * self.src_image + self.dst_weight * \
            img.astype(np.float32)
        if np.issubdtype(np.asarray(img).dtype, np.integer):
            return np.clip(out, 0, 255).astype(np.asarray(img).dtype)
        return out.astype(np.asarray(img).dtype)

    def apply_coords(self, coords):
        return coords

    def apply_segmentation(self, seg):
        return seg

    def inverse(self):
        raise NotImplementedError("a photometric blend has no inverse")


class ExtentTransform(Transform):
    """Resample the rectangle ``src_rect`` (x0, y0, x1, y1; it may reach
    past the image, which reads as 0) to ``output_size`` (h, w), as
    Pillow's ``transform(EXTENT, BILINEAR)`` does; label maps by
    nearest."""

    def __init__(self, src_rect, output_size):
        self.src_rect = tuple(float(v) for v in src_rect)
        self.out_hw = tuple(int(v) for v in output_size)

    def output_size(self, hw):
        return self.out_hw

    def _affine(self):
        # PIL/Image.py __transformer: EXTENT -> AFFINE
        x0, y0, x1, y1 = self.src_rect
        h, w = self.out_hw
        return ((x1 - x0) / w, 0, x0, 0, (y1 - y0) / h, y0)

    def apply_image(self, img):
        h, w = self.out_hw
        return affine_resample(img, w, h, self._affine(), bilinear=True)

    def apply_segmentation(self, seg):
        h, w = self.out_hw
        return affine_resample(seg, w, h, self._affine(), bilinear=False)

    def apply_coords(self, coords):
        x0, y0, x1, y1 = self.src_rect
        h, w = self.out_hw
        coords = coords.astype(np.float32).copy()
        coords[:, 0] = (coords[:, 0] - x0) * (w / max(x1 - x0, 1e-6))
        coords[:, 1] = (coords[:, 1] - y0) * (h / max(y1 - y0, 1e-6))
        return coords

    def inverse(self):
        raise NotImplementedError("an extent has no inverse (train only)")


class RotationTransform(Transform):
    """Rotate by ``angle`` degrees counterclockwise about the centre, the
    canvas expanded to hold the whole image (``expand``). The pixels are
    ``Image.rotate``'s (:func:`rotate_like_pillow`); ``new_h``/``new_w``
    and ``apply_coords`` are the JAX package's formulas, whose canvas
    ``ceil(|h cos| + |w sin|)`` can differ by a pixel from Pillow's
    (ROADMAP.md section 3): the port keeps both as the reference has
    them."""

    def __init__(self, h: int, w: int, angle: float, expand: bool = True):
        self.h, self.w, self.angle, self.expand = h, w, float(angle), expand
        rad = np.deg2rad(self.angle)
        self._cos, self._sin = np.cos(rad), np.sin(rad)
        # snap float fuzz at right angles so expanded sizes are exact
        if abs(self._cos) < 1e-12:
            self._cos = 0.0
        if abs(self._sin) < 1e-12:
            self._sin = 0.0
        if expand:
            self.new_w = int(np.ceil(abs(w * self._cos) + abs(h * self._sin)))
            self.new_h = int(np.ceil(abs(h * self._cos) + abs(w * self._sin)))
        else:
            self.new_h, self.new_w = h, w

    def output_size(self, hw):
        return (self.new_h, self.new_w)

    def apply_image(self, img):
        return rotate_like_pillow(img, self.angle, True, self.expand)

    def apply_segmentation(self, seg):
        return rotate_like_pillow(seg, self.angle, False, self.expand)

    def apply_coords(self, coords):
        coords = coords.astype(np.float32).copy()
        cx, cy = self.w / 2, self.h / 2
        ncx, ncy = self.new_w / 2, self.new_h / 2
        x = coords[:, 0] - cx
        y = coords[:, 1] - cy
        # image y grows downward: counterclockwise by `angle`
        coords[:, 0] = x * self._cos + y * self._sin + ncx
        coords[:, 1] = -x * self._sin + y * self._cos + ncy
        return coords

    def inverse(self):
        if not self.expand:
            raise NotImplementedError("inverse only defined for expand=True")
        inv = RotationTransform(self.new_h, self.new_w, -self.angle,
                                expand=True)
        # the inverse canvas is larger than the original: crop back to
        # (h, w) about the centre
        crop = CropTransform(
            (inv.new_w - self.w) // 2, (inv.new_h - self.h) // 2,
            self.w, self.h, orig_w=inv.new_w, orig_h=inv.new_h)
        return TransformList([inv, crop])


# ---------------------------------------------------------------------------
# Random augmentations: a Transform drawn from an image and an rng
# ---------------------------------------------------------------------------

class Augmentation:
    def get_transform(self, image: np.ndarray,
                      rng: np.random.RandomState) -> Transform:
        raise NotImplementedError


class ResizeShortestEdge(Augmentation):
    """Resize the shortest edge to one of ``short_edge_lengths`` ("choice")
    or to a size drawn from their range ("range"), the longest capped at
    ``max_size``."""

    def __init__(self, short_edge_lengths, max_size: int = 1 << 30,
                 sample_style: str = "choice"):
        if isinstance(short_edge_lengths, int):
            short_edge_lengths = (short_edge_lengths,)
        self.short_edge_lengths = tuple(short_edge_lengths)
        self.max_size = max_size
        self.sample_style = sample_style

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

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        if self.sample_style == "range":
            size = int(rng.randint(min(self.short_edge_lengths),
                                   max(self.short_edge_lengths) + 1))
        else:
            size = int(self.short_edge_lengths[
                rng.randint(len(self.short_edge_lengths))])
        if size == 0:
            return NoOpTransform()
        new_h, new_w = self.target_size(h, w, size, self.max_size)
        return ResizeTransform(h, w, new_h, new_w)


class RandomFlip(Augmentation):
    """Horizontal flip with probability ``prob``."""

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def get_transform(self, image, rng):
        if rng.uniform() < self.prob:
            return HFlipTransform(image.shape[1])
        return NoOpTransform()


class RandomCrop(Augmentation):
    """A crop of "relative", "relative_range" or "absolute" size at a
    uniform position."""

    def __init__(self, crop_type: str, crop_size):
        if crop_type not in ("relative", "relative_range", "absolute"):
            raise ValueError(f"unknown crop type {crop_type!r}")
        self.crop_type = crop_type
        self.crop_size = tuple(crop_size)

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        ch, cw = self._crop_hw(h, w, rng)
        y0 = int(rng.randint(h - ch + 1))
        x0 = int(rng.randint(w - cw + 1))
        return CropTransform(x0, y0, cw, ch, orig_w=w, orig_h=h)

    def _crop_hw(self, h, w, rng):
        if self.crop_type == "relative":
            ch, cw = self.crop_size
            return int(h * ch + 0.5), int(w * cw + 0.5)
        if self.crop_type == "relative_range":
            lo = np.asarray(self.crop_size, dtype=np.float32)
            ch, cw = lo + rng.rand(2) * (1 - lo)
            return int(h * ch + 0.5), int(w * cw + 0.5)
        return (min(int(self.crop_size[0]), h), min(int(self.crop_size[1]), w))


class RandomRotation(Augmentation):
    """Rotate by an angle drawn uniformly from ``angle`` = (lo, hi) when
    ``sample_style`` is "range", else chosen from the list."""

    def __init__(self, angle, expand: bool = True,
                 sample_style: str = "range"):
        if isinstance(angle, (int, float)):
            angle = (angle,)
        self.angle = tuple(float(a) for a in angle)
        self.expand = expand
        self.sample_style = sample_style

    def get_transform(self, image, rng):
        if self.sample_style == "range" and len(self.angle) == 2:
            a = float(rng.uniform(self.angle[0], self.angle[1]))
        else:
            a = self.angle[int(rng.randint(len(self.angle)))]
        if a % 360 == 0:
            return NoOpTransform()
        h, w = image.shape[:2]
        return RotationTransform(h, w, a, expand=self.expand)


class RandomExtent(Augmentation):
    """A sub-rectangle scaled by a factor from ``scale_range`` and shifted
    by up to ``shift_range`` / 2 of each side (it may reach past the
    image), resampled to its own size."""

    def __init__(self, scale_range, shift_range):
        self.scale_range = tuple(scale_range)
        self.shift_range = tuple(shift_range)

    def get_transform(self, image, rng):
        h, w = image.shape[:2]
        rect = np.array([-0.5 * w, -0.5 * h, 0.5 * w, 0.5 * h], np.float32)
        rect *= rng.uniform(self.scale_range[0], self.scale_range[1])
        rect[0::2] += self.shift_range[0] * w * (rng.rand() - 0.5)
        rect[1::2] += self.shift_range[1] * h * (rng.rand() - 0.5)
        rect[0::2] += 0.5 * w
        rect[1::2] += 0.5 * h
        return ExtentTransform(rect, (int(rect[3] - rect[1]),
                                      int(rect[2] - rect[0])))


class RandomBrightness(Augmentation):
    """Scale the intensity by w from [intensity_min, intensity_max]: a
    blend against black."""

    def __init__(self, intensity_min: float, intensity_max: float):
        self.intensity_min, self.intensity_max = intensity_min, intensity_max

    def get_transform(self, image, rng):
        w = rng.uniform(self.intensity_min, self.intensity_max)
        return BlendTransform(0.0, src_weight=1 - w, dst_weight=w)


class RandomContrast(Augmentation):
    """A blend against the image's mean intensity."""

    def __init__(self, intensity_min: float, intensity_max: float):
        self.intensity_min, self.intensity_max = intensity_min, intensity_max

    def get_transform(self, image, rng):
        w = rng.uniform(self.intensity_min, self.intensity_max)
        return BlendTransform(float(np.asarray(image, np.float32).mean()),
                              src_weight=1 - w, dst_weight=w)


class RandomSaturation(Augmentation):
    """A blend against each pixel's gray level, with BGR weights (the data
    path carries BGR)."""

    def __init__(self, intensity_min: float, intensity_max: float):
        self.intensity_min, self.intensity_max = intensity_min, intensity_max

    def get_transform(self, image, rng):
        if image.shape[-1] != 3:
            raise ValueError("RandomSaturation needs a BGR image")
        w = rng.uniform(self.intensity_min, self.intensity_max)
        gray = (np.asarray(image, np.float32)
                @ np.array([0.114, 0.587, 0.299], np.float32))[..., None]
        return BlendTransform(gray, src_weight=1 - w, dst_weight=w)


class RandomLighting(Augmentation):
    """AlexNet's PCA colour jitter: a shift along ImageNet's colour
    eigenvectors (BGR order) scaled by their eigenvalues and normal
    weights of scale ``scale``."""

    _EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)[:, ::-1]
    _EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)

    def __init__(self, scale: float):
        self.scale = scale

    def get_transform(self, image, rng):
        if image.shape[-1] != 3:
            raise ValueError("RandomLighting needs a BGR image")
        weights = rng.normal(scale=self.scale, size=3).astype(np.float32)
        shift = self._EIGVEC @ (weights * self._EIGVAL)
        return BlendTransform(shift[None, None, :], src_weight=1.0,
                              dst_weight=1.0)


def apply_augmentations(augs: Sequence[Augmentation], image: np.ndarray,
                        rng: np.random.RandomState):
    """Draw and apply each augmentation in turn; returns the image and the
    :class:`TransformList` that maps boxes the same way."""
    tfms = []
    for a in augs:
        t = a.get_transform(image, rng)
        image = t.apply_image(image)
        tfms.append(t)
    return image, TransformList(tfms)
