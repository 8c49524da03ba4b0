"""Write the JPEG fixtures that hold the port's decoder to its reference
(``drn_wsod_torch/data/jpeg_fixtures/``): synthetic images made from a seed
(gradients, filled shapes, mild noise), encoded with Pillow in the layouts
the decoder must take, and a ``manifest.json`` with each file's encode
parameters, shape and decode digests:

    python -m drn_wsod_torch.tools.make_jpeg_fixtures [--seed 0]

``pillow_sha256`` is the sha256 of Pillow's ``convert("RGB")`` decode (the
scale-8 reference); ``sha256[s]`` is that of the port's decode at
``scale_num`` s (1-8), which ``tests/test_torch_jpeg.py`` holds to the JAX
package's libjpeg binding and ``chip_smoke.py`` to the decoder built on
the GPU machine, which has neither Pillow nor libjpeg. A file the decoder
does not take records its ``reason`` instead. Needs Pillow.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[1] / "data" / "jpeg_fixtures"

# name -> (height, width, Pillow mode, save keywords, truncate to fraction)
FIXTURES = {
    "voc_500x375_q90.jpg": (375, 500, "RGB", dict(quality=90,
                                                   subsampling=2), None),
    "voc_500x375_q90_progressive.jpg": (375, 500, "RGB", dict(
        quality=90, subsampling=2, progressive=True), None),
    "coco_640x480_q75.jpg": (480, 640, "RGB", dict(quality=75,
                                                    subsampling=2), None),
    "odd_61x77_444.jpg": (77, 61, "RGB", dict(quality=90, subsampling=0),
                          None),
    "odd_61x77_422.jpg": (77, 61, "RGB", dict(quality=90, subsampling=1),
                          None),
    "odd_61x77_420.jpg": (77, 61, "RGB", dict(quality=90, subsampling=2),
                          None),
    "restart_blocks3.jpg": (101, 75, "RGB", dict(
        quality=90, restart_marker_blocks=3), None),
    "restart_rows1_progressive.jpg": (101, 75, "RGB", dict(
        quality=90, restart_marker_rows=1, progressive=True), None),
    "q30_optimize.jpg": (120, 160, "RGB", dict(quality=30, optimize=True),
                         None),
    "gray_75x101.jpg": (101, 75, "L", dict(quality=85), None),
    "cmyk_64x48.jpg": (48, 64, "CMYK", dict(quality=90), None),
    "truncated_60pct.jpg": (120, 160, "RGB", dict(quality=90), 0.6),
}


def synthetic_image(h: int, w: int, rng: np.random.RandomState) -> np.ndarray:
    """An (h, w, 3) uint8 RGB image: two colour gradients, a few filled
    rectangles and ellipses, and noise of sigma 3."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    c0, c1 = rng.uniform(0, 255, 3), rng.uniform(0, 255, 3)
    t = (x / max(w - 1, 1) + y / max(h - 1, 1)) / 2
    img = c0 * (1 - t[..., None]) + c1 * t[..., None]
    for _ in range(4):
        x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
        rw, rh = rng.uniform(w / 8, w / 3), rng.uniform(h / 8, h / 3)
        colour = rng.uniform(0, 255, 3)
        if rng.rand() < 0.5:
            m = (abs(x - x0) < rw / 2) & (abs(y - y0) < rh / 2)
        else:
            m = ((x - x0) / rw) ** 2 + ((y - y0) / rh) ** 2 < 0.25
        img[m] = colour
    img += rng.normal(0, 3, img.shape)
    return np.clip(img + 0.5, 0, 255).astype(np.uint8)


def digest(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb, np.uint8).tobytes()
                          ).hexdigest()


def main(argv=None) -> dict:
    from PIL import Image

    from .. import native

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rng = np.random.RandomState(args.seed)
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    manifest = {"seed": args.seed, "files": {}}
    for name, (h, w, mode, kw, cut) in FIXTURES.items():
        im = Image.fromarray(synthetic_image(h, w, rng))
        if mode != "RGB":
            im = im.convert(mode)
        buf = io.BytesIO()
        im.save(buf, "JPEG", **kw)
        data = buf.getvalue()
        if cut is not None:
            data = data[:int(len(data) * cut)]
        (FIXTURE_DIR / name).write_bytes(data)
        entry = {"mode": mode, "save": kw, "truncate": cut,
                 "shape": [h, w, 3], "bytes": len(data)}
        reason = native.jpeg_unsupported_reason(data)
        if reason is not None:
            entry["reason"] = reason
        else:
            entry["sha256"] = {str(s): digest(native.jpeg_decode(data, s))
                               for s in range(1, 9)}
            if cut is None:
                with Image.open(io.BytesIO(data)) as dec:
                    entry["pillow_sha256"] = digest(
                        np.asarray(dec.convert("RGB")))
        manifest["files"][name] = entry
    (FIXTURE_DIR / "manifest.json").write_text(
        json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(e["bytes"] for e in manifest["files"].values())
    print(f"wrote {len(FIXTURES)} fixtures, {total} bytes, to {FIXTURE_DIR}")
    return manifest


if __name__ == "__main__":
    main()
