"""Image decoding and size buckets (counterpart of
``drn_wsod_tpu/data/mapper.py:read_image`` and ``pick_bucket``). The
dataset mapper comes with the data path (ROADMAP.md queue 1, item 10)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def read_image(path: str, fmt: str = "BGR") -> np.ndarray:
    """Decode an image file to an (H, W, 3) uint8 array in ``fmt`` channel
    order ("BGR" or "RGB") with Pillow. The JAX package decodes JPEGs with
    its own libjpeg binding, which it holds bit-exact to Pillow's decode;
    the port has no other decoder."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            "read_image needs Pillow (the PIL package) to decode "
            f"{path!r}") from e
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    if fmt == "BGR":
        arr = arr[:, :, ::-1]
    return np.ascontiguousarray(arr)


def pick_bucket(h: int, w: int, buckets: Sequence[int],
                divisibility: int = 32) -> int:
    """Smallest square bucket covering (h, w); beyond the largest, the
    longer side rounded up to ``divisibility``."""
    m = max(h, w)
    for b in sorted(buckets):
        if b >= m:
            return b
    return int(np.ceil(m / divisibility) * divisibility)
