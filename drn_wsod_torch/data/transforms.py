"""Host-side image and box transforms and the random augmentations of the
data path (counterpart of ``drn_wsod_tpu/data/transforms.py``): the
deterministic transforms (no-op, list, resize, horizontal flip, crop), the
augmentations that draw them from a ``np.random.RandomState`` (shortest-edge
resize, flip, crop) and ``apply_augmentations``.

The resize computes what Pillow's ``Image.resize(..., BILINEAR)`` computes on
uint8, bit for bit, in numpy (``resize_bilinear``): the port resizes
without Pillow, which the GPU machines it trains on may lack. The
photometric, rotation and extent augmentations are not ported yet
(ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

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


class Transform:
    """A deterministic transform of images and of XYXY boxes."""

    def output_size(self, hw):
        """(h, w) -> the transformed (h, w), without touching pixels (lets
        the mapper plan size buckets from record metadata)."""
        return hw

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

    def inverse(self):
        return TransformList([t.inverse() for t in reversed(self.transforms)])

    def __add__(self, other: Transform) -> "TransformList":
        others = (other.transforms if isinstance(other, TransformList)
                  else [other])
        return TransformList(self.transforms + list(others))


class ResizeTransform(Transform):
    """Resize an (h, w) image to (new_h, new_w): pixels by
    :func:`resize_bilinear` (Pillow's bilinear filter), coordinates by the
    float32 ratio."""

    def __init__(self, h: int, w: int, new_h: int, new_w: int):
        self.h, self.w, self.new_h, self.new_w = h, w, new_h, new_w

    def output_size(self, hw):
        return (self.new_h, self.new_w)

    def apply_image(self, img):
        if img.shape[:2] == (self.new_h, self.new_w):
            return img
        return resize_bilinear(img, self.new_h, self.new_w)

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
