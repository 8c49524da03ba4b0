"""Write the JPEG fixtures that hold the port's decoder to its references
(``drn_wsod_torch/data/jpeg_fixtures/``): synthetic images made from a seed
(gradients, filled shapes, mild noise), encoded in the layouts the decoder
must take, and a ``manifest.json`` with each file's parameters, shape and
decode digests:

    python -m drn_wsod_torch.tools.make_jpeg_fixtures [--seed 0]

``FIXTURES`` are Pillow's own files (baseline, progressive, sampling,
restarts, grayscale, CMYK, a baseline file cut short). ``MADE`` are the
files Pillow cannot write or that an edit makes: YCCK (a CMYK file's Adobe
transform byte set to 2), arithmetic coding (the coefficients of a
baseline file of ``FIXTURES``, its ``twin``, re-encoded by
``tools/jpeg_transcode.py``: both decode to the same pixels), progressive files cut inside their first AC scan, between two
scans and inside a refinement scan (where libjpeg smooths the blocks),
lossless files, a PNG named ``.JPEG`` and a JPEG named ``.png``; and, under
``voc/``, one VOC-sized (500 x 375) file of each new JPEG kind for
``chip_smoke.py``'s phase 29. ``MADE`` draws from a second random stream
(``--seed`` + 1), so that adding to it leaves the files above unchanged.

Each entry records ``sha256[s]``, the port's decode (``native.
jpeg_decode``) at each ``scale_num`` s it takes: 1-8 where libjpeg takes
the file (``libjpeg`` true), 8 alone for CMYK, YCCK and lossless files,
which only Pillow decodes; ``pillow_sha256``, Pillow's ``convert("RGB")``,
null where Pillow refuses the file (one cut short); and
``read_image_sha256``, what the JAX package's ``read_image`` returns (RGB)
with Pillow present: libjpeg's decode where its binding takes a ``.jpg``
file, else Pillow's. ``tests/test_torch_jpeg.py`` holds the JAX binding,
Pillow and the JAX ``read_image`` to these digests, and ``chip_smoke.py``
the decoder built on the GPU machine, which has neither Pillow nor
libjpeg. Needs Pillow.
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


# the files of MADE: name -> (kind, height, width, parameters)
DAC = dict(L=(1, 2), U=(3, 4), K=(8, 3))
_PROGRESSIVE = dict(quality=90, subsampling=2, progressive=True)
MADE = {
    "ycck_64x48.jpg": ("ycck", 48, 64, dict(quality=90)),
    "cmyk_61x77_420_progressive.jpg": ("cmyk", 77, 61, _PROGRESSIVE),
    "arith_61x77_420.jpg": ("arithmetic", 77, 61, dict(
        twin="odd_61x77_420.jpg", progressive=False, restart=0, dac=None)),
    "arith_61x77_420_progressive.jpg": ("arithmetic", 77, 61, dict(
        twin="odd_61x77_420.jpg", progressive=True, restart=5, dac=DAC)),
    "arith_gray_75x101.jpg": ("arithmetic", 101, 75, dict(
        twin="gray_75x101.jpg", progressive=False, restart=7, dac=DAC)),
    "truncated_75x101_ac1.jpg": ("truncated", 101, 75, dict(
        save=_PROGRESSIVE, cut="ac1")),
    "truncated_75x101_between.jpg": ("truncated", 101, 75, dict(
        save=_PROGRESSIVE, cut="between")),
    "truncated_75x101_refine.jpg": ("truncated", 101, 75, dict(
        save=_PROGRESSIVE, cut="refine")),
    "lossless_gray_33x40.jpg": ("lossless", 40, 33, dict(
        colour="gray", predictor=7, pt=0, restart_rows=0, hv=None)),
    "lossless_rgb_33x40.jpg": ("lossless", 40, 33, dict(
        colour="rgb", predictor=4, pt=1, restart_rows=3, hv=None)),
    "lossless_rgb_420_34x40.jpg": ("lossless", 40, 34, dict(
        colour="none", predictor=1, pt=0, restart_rows=0,
        hv=(0x22, 0x11, 0x11))),
    "misnamed_png.JPEG": ("png", 48, 64, {}),
    "misnamed_jpeg.png": ("pillow", 48, 64, dict(quality=90)),
    "voc/cmyk_500x375.jpg": ("cmyk", 375, 500, dict(quality=75)),
    "voc/ycck_500x375.jpg": ("ycck", 375, 500, dict(quality=75)),
    "voc/arith_500x375.jpg": ("arithmetic", 375, 500, dict(
        twin="voc_500x375_q90.jpg", progressive=False, restart=0,
        dac=None)),
    "voc/arith_500x375_progressive.jpg": ("arithmetic", 375, 500, dict(
        twin="voc_500x375_q90.jpg", progressive=True, restart=0,
        dac=DAC)),
    "voc/truncated_500x375_ac1.jpg": ("truncated", 375, 500, dict(
        save=_PROGRESSIVE, cut="ac1")),
    "voc/truncated_500x375_between.jpg": ("truncated", 375, 500, dict(
        save=_PROGRESSIVE, cut="between")),
    "voc/truncated_500x375_refine.jpg": ("truncated", 375, 500, dict(
        save=_PROGRESSIVE, cut="refine")),
}
# the kinds libjpeg-turbo 2.1 (the JAX package's binding) does not take
PILLOW_ONLY = ("cmyk", "ycck", "lossless")


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


def _save(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def cut_point(data: bytes, where: str) -> int:
    """Where to cut a progressive file of libjpeg's script: "ac1", inside
    its first AC scan; "between", at the start of its first AC
    refinement scan (every first pass in, no refinement); "refine",
    inside that scan."""
    sos = [i for i in range(len(data) - 1)
           if data[i] == 0xFF and data[i + 1] == 0xDA]
    # an SOS segment: FF DA, length, n, n (id, tables), Ss, Se, Ah | Al
    head = [(data[i + 5 + 2 * data[i + 4]], data[i + 7 + 2 * data[i + 4]])
            for i in sos]
    first_ac = next(k for k, (ss, _) in enumerate(head) if ss)
    refine = next(k for k, (ss, a) in enumerate(head) if ss and a >> 4)
    ends = sos[1:] + [len(data)]
    return {"ac1": (sos[first_ac] + ends[first_ac]) // 2,
            "between": sos[refine],
            "refine": (sos[refine] + ends[refine]) // 2}[where]


def make(kind: str, h: int, w: int, params: dict,
         rng: np.random.RandomState) -> bytes:
    """The bytes of one file of ``MADE``."""
    from PIL import Image

    from ..data.png import encode_png
    from . import jpeg_transcode

    rgb = synthetic_image(h, w, rng)
    if kind == "png":
        return encode_png(rgb)
    if kind == "pillow":
        return _save(Image.fromarray(rgb), **params)
    if kind in ("cmyk", "ycck"):
        data = _save(Image.fromarray(rgb).convert("CMYK"), **params)
        if kind == "ycck":
            i = data.index(b"Adobe") + 11
            data = data[:i] + b"\x02" + data[i + 1:]
        return data
    if kind == "arithmetic":
        return jpeg_transcode.arithmetic(
            (FIXTURE_DIR / params["twin"]).read_bytes(),
            params["progressive"], params["restart"], params["dac"])
    if kind == "truncated":
        data = _save(Image.fromarray(rgb), **params["save"])
        return data[:cut_point(data, params["cut"])]
    if kind == "lossless":
        hv = params["hv"]
        if hv is None:
            samples = rgb[..., 0] if params["colour"] == "gray" else rgb
        else:
            hs, vs = [x >> 4 for x in hv], [x & 15 for x in hv]
            samples = [np.ascontiguousarray(
                rgb[::max(vs) // v, ::max(hs) // hh, i])
                for i, (hh, v) in enumerate(zip(hs, vs))]
        return jpeg_transcode.lossless(samples, params["predictor"],
                                       params["pt"], params["restart_rows"],
                                       params["colour"], hv)
    raise ValueError(f"unknown fixture kind {kind!r}")


def entry_for(name: str, data: bytes, kind: str, shape) -> dict:
    """The manifest entry of a file: its digests (module docstring)."""
    from PIL import Image

    from .. import native

    libjpeg = kind not in PILLOW_ONLY and kind != "png"
    entry = {"kind": kind, "shape": list(shape), "bytes": len(data),
             "libjpeg": libjpeg, "sha256": {}}
    for s in range(1, 9) if libjpeg else (8,):
        a = native.jpeg_decode(data, s) if kind != "png" else None
        if a is not None:
            entry["sha256"][str(s)] = digest(a)
    try:
        with Image.open(io.BytesIO(data)) as im:
            entry["mode"] = im.mode
            entry["pillow_sha256"] = digest(np.asarray(im.convert("RGB")))
    except OSError:
        entry["pillow_sha256"] = None
    jax_uses_binding = libjpeg and name.lower().endswith((".jpg", ".jpeg"))
    entry["read_image_sha256"] = (entry["sha256"]["8"] if jax_uses_binding
                                  else entry["pillow_sha256"])
    if entry["pillow_sha256"] and "8" in entry["sha256"] and \
            entry["pillow_sha256"] != entry["sha256"]["8"]:
        raise AssertionError(f"{name}: the port's decode is not Pillow's")
    return entry


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
        data = _save(im, **kw)
        if cut is not None:
            data = data[:int(len(data) * cut)]
        (FIXTURE_DIR / name).write_bytes(data)
        kind = "cmyk" if mode == "CMYK" else (
            "truncated" if cut else "pillow")
        entry = entry_for(name, data, kind, (h, w, 3))
        entry.update({"mode": mode, "save": kw, "truncate": cut})
        manifest["files"][name] = entry
    rng = np.random.RandomState(args.seed + 1)
    for name, (kind, h, w, params) in MADE.items():
        data = make(kind, h, w, params, rng)
        path = FIXTURE_DIR / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
        entry = entry_for(name, data, kind, (h, w, 3))
        entry["params"] = params
        manifest["files"][name] = entry
    (FIXTURE_DIR / "manifest.json").write_text(
        json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    total = sum(e["bytes"] for e in manifest["files"].values())
    print(f"wrote {len(manifest['files'])} fixtures, {total} bytes, to "
          f"{FIXTURE_DIR}")
    return manifest


if __name__ == "__main__":
    main()
