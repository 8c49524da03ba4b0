"""Write the fixtures that hold the port's PNG reader (``data/png.py``)
and the semantic-segmentation mapper to Pillow
(``drn_wsod_torch/data/png_fixtures/``):

    python -m drn_wsod_torch.tools.make_png_fixtures [--seed 0]

All made from the seed:

  * ``modes/``: small PNGs (13 x 17, odd sizes) of every mode and depth
    the reader takes: gray at 1, 2, 4 and 8 bits, palette at 1, 2, 4 and 8
    bits (a short palette, indices past its end, a tRNS chunk), gray with
    alpha, RGB and RGBA, each row's filter type cycling through all five
    and the IDAT stream split into three chunks; an 8-bit RGB file for
    each filter type alone; interlaced (Adam7) files of every colour type
    and depth, and 16-bit files of every colour type that has them (those
    after the first interlaced and 16-bit ones drawn from a second random
    stream, ``--seed`` + 1, which leaves the files before them unchanged).
    Encoded by :func:`encode_png`, which chooses the filters, as Pillow
    does not;
  * ``voc/``: a VOC-sized (500 x 375) interlaced RGB file and a 16-bit RGB
    one, smooth content, for ``chip_smoke.py``'s phase 29;
  * ``panoptic/``: a COCO panoptic-separated tree (layout of
    ``data/datasets/coco.py``'s builtin splits: ``annotations/
    {instances,panoptic}_{train,val}2017.json``, ``panoptic_{split}/`` RGB
    segment-id PNGs, ``panoptic_stuff_{split}/`` label PNGs, written by
    Pillow) over the images and polygons of the mask fixtures
    (``mask_fixtures/manifest.json``, "coco"): 53 stuff categories in
    bands behind the instances, each instance a segment of its own, the
    crowd region void;
  * ``manifest.json``: for each file the sha256 of Pillow's decode
    (``np.asarray(Image.open(f))``, with its dtype and shape) and of its
    ``convert("RGB")``; and for each train image of the tree and a seed of
    its own, the sha256 of the ``sem_seg`` canvas the training mapper of
    ``configs/Misc/semantic_R_50_FPN_1x.yaml`` makes (the resize and flip
    that seed draws, Pillow's NEAREST resize), with its bucket.

``tests/test_torch_png.py`` holds the committed files and manifest to a
fresh build (so a stale fixture shows) and the reader to them;
``chip_smoke.py`` holds the reader and the mapper, on a machine without
Pillow. Needs Pillow.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[1] / "data" / "png_fixtures"
SEM_YAML = (Path(__file__).resolve().parents[2] / "configs" / "Misc"
            / "semantic_R_50_FPN_1x.yaml")
N_STUFF = 53                      # SEM_SEG_HEAD.NUM_CLASSES 54 less "things"
STUFF_IDS = tuple(92 + 2 * i for i in range(N_STUFF))
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def digest(a) -> str:
    """sha256 of an array's bytes (C order), a bool array's as uint8 0/1
    (Pillow's mode "1" arrays hold 255 for True)."""
    a = np.asarray(a)
    if a.dtype == bool:
        a = (a.view(np.uint8) != 0).astype(np.uint8)
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _filter_row(row: np.ndarray, prev: np.ndarray, bpp: int,
                t: int) -> np.ndarray:
    x = row.astype(np.int32)
    b = prev.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if t == 0:
        pred = 0
    elif t == 1:
        pred = a
    elif t == 2:
        pred = b
    elif t == 3:
        pred = (a + b) >> 1
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return ((x - pred) & 0xFF).astype(np.uint8)


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, ch) samples -> (H, stride) bytes of packed scanlines."""
    H, W, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(H, -1).view(np.uint8)
    if depth == 8:
        return samples.reshape(H, W * ch).astype(np.uint8)
    bits = ((samples[..., 0][..., None].astype(np.uint8)
             >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1)
    return np.packbits(bits.reshape(H, W * depth), axis=1)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(samples: np.ndarray, colour: int, depth: int = 8,
               palette: Optional[np.ndarray] = None,
               trns: Optional[bytes] = None,
               filters: Sequence[int] = (0,), idat_chunks: int = 1,
               interlace: bool = False) -> bytes:
    """(H, W, channels) samples (or (H, W)) -> PNG bytes of colour type
    ``colour`` at ``depth`` bits; row r takes filter ``filters[r %
    len(filters)]`` (each Adam7 pass counts its own rows), the zlib stream
    cut into ``idat_chunks`` IDAT chunks."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    H, W, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    images = ([samples[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
              if interlace else [samples])
    raw = bytearray()
    for img in images:
        if img.size == 0:
            continue
        rows = _pack_rows(img, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for r, row in enumerate(rows):
            t = filters[r % len(filters)]
            raw.append(t)
            raw += _filter_row(row, prev, bpp, t).tobytes()
            prev = row
    z = zlib.compress(bytes(raw), 9)
    cuts = np.linspace(0, len(z), idat_chunks + 1).astype(int)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, colour, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    for a, b in zip(cuts[:-1], cuts[1:]):
        out += _chunk(b"IDAT", z[a:b])
    return out + _chunk(b"IEND", b"")


def mode_files(rng: np.random.RandomState, h: int = 13, w: int = 17
               ) -> Dict[str, bytes]:
    """{file name: PNG bytes} of ``modes/`` (module docstring)."""
    cyc = (0, 1, 2, 3, 4)
    files = {}
    for depth in (1, 2, 4, 8):
        files[f"gray{depth}.png"] = encode_png(
            rng.randint(0, 1 << depth, (h, w)), 0, depth, filters=cyc,
            idat_chunks=3)
        n = min(1 << depth, 5) if depth < 8 else 200
        files[f"palette{depth}.png"] = encode_png(
            rng.randint(0, 1 << depth, (h, w)), 3, depth,
            palette=rng.randint(0, 256, (n, 3)),
            trns=bytes(rng.randint(0, 256, n // 2 + 1).astype(np.uint8)),
            filters=cyc, idat_chunks=3)
    for name, colour, ch in (("gray_alpha8", 4, 2), ("rgb8", 2, 3),
                             ("rgba8", 6, 4)):
        files[f"{name}.png"] = encode_png(
            rng.randint(0, 256, (h, w, ch)), colour, 8, filters=cyc,
            idat_chunks=3)
    smooth = np.cumsum(rng.randint(0, 9, (h, w, 3)), axis=1) % 256
    for t in range(5):
        files[f"rgb8_filter{t}.png"] = encode_png(smooth, 2, 8, filters=(t,))
    files["interlaced_rgb8.png"] = encode_png(
        rng.randint(0, 256, (h, w, 3)), 2, 8, filters=cyc, interlace=True)
    files["gray16.png"] = encode_png(rng.randint(0, 1 << 16, (h, w)), 0, 16,
                                     filters=cyc)
    return files


# (name, colour type, depth, channels) of the Adam7 and 16-bit files
WIDE = [(f"gray{d}", 0, d, 1) for d in (1, 2, 4, 8, 16)] + \
    [(f"palette{d}", 3, d, 1) for d in (1, 2, 4, 8)] + \
    [(f"gray_alpha{d}", 4, d, 2) for d in (8, 16)] + \
    [(f"rgb{d}", 2, d, 3) for d in (8, 16)] + \
    [(f"rgba{d}", 6, d, 4) for d in (8, 16)]


def wide_files(rng: np.random.RandomState, h: int = 13, w: int = 17
               ) -> Dict[str, bytes]:
    """{file name: PNG bytes}: every kind of ``WIDE`` interlaced, the
    16-bit ones also plain (gray16 is in :func:`mode_files`), and an
    interlaced file smaller than Adam7's 8 x 8 tile (empty passes)."""
    cyc = (0, 1, 2, 3, 4)
    files = {}
    for name, colour, depth, ch in WIDE:
        for interlace in (True, False):
            if not interlace and (depth != 16 or colour == 0):
                continue
            samples = rng.randint(0, 1 << depth, (h, w, ch))
            palette = (rng.randint(0, 256, (min(1 << depth, 200), 3))
                       if colour == 3 else None)
            key = f"adam7_{name}.png" if interlace else f"{name}.png"
            files[key] = encode_png(samples, colour, depth, palette,
                                    filters=cyc, idat_chunks=2,
                                    interlace=interlace)
    files["adam7_rgb8_3x5.png"] = encode_png(
        rng.randint(0, 256, (3, 5, 3)), 2, 8, filters=cyc, interlace=True)
    return files


def voc_files(rng: np.random.RandomState, h: int = 375, w: int = 500
              ) -> Dict[str, bytes]:
    """The VOC-sized files: smooth RGB (two gradients and filled
    rectangles), interlaced at 8 bits and plain at 16."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    c0, c1 = rng.uniform(0, 255, 3), rng.uniform(0, 255, 3)
    t = (x / (w - 1) + y / (h - 1)) / 2
    img = c0 * (1 - t[..., None]) + c1 * t[..., None]
    for _ in range(4):
        x0, y0 = rng.randint(0, w - 50), rng.randint(0, h - 50)
        img[y0:y0 + rng.randint(20, 150), x0:x0 + rng.randint(20, 150)] = \
            rng.uniform(0, 255, 3)
    wide = np.clip(img * 257, 0, 65535).astype(np.int64)
    return {"adam7_rgb8_500x375.png": encode_png(wide >> 8, 2, 8,
                                                  filters=(4,),
                                                  interlace=True),
            "rgb16_500x375.png": encode_png(wide, 2, 16, filters=(4,))}


def pillow_decodes(data: bytes) -> Dict:
    """Pillow's decode of PNG bytes: mode, dtype, shape and the sha256 of
    ``np.asarray`` and of ``convert("RGB")``."""
    import warnings

    from PIL import Image

    with Image.open(io.BytesIO(data)) as im, warnings.catch_warnings():
        # a palette's tRNS: Pillow advises RGBA, which is not asked here
        warnings.simplefilter("ignore", UserWarning)
        a = np.asarray(im)
        rgb = np.asarray(im.convert("RGB"))
        return {"mode": im.mode, "dtype": str(a.dtype), "shape": list(a.shape),
                "sha256": digest(a), "rgb_sha256": digest(rgb)}


def id2rgb(ids: np.ndarray) -> np.ndarray:
    """Segment ids -> the panoptic PNG's RGB (R + 256 G + 256^2 B)."""
    return np.stack([ids % 256, ids // 256 % 256, ids // 65536],
                    -1).astype(np.uint8)


def panoptic_split(coco: dict, rng: np.random.RandomState):
    """(panoptic json dict, {file name: (segment ids, stuff labels)}) of
    one split of the mask fixtures: 2-4 stuff bands an image, the
    instances painted over them in order (each its own segment, thing
    label 0), the crowd region void (id 0, label 255)."""
    from PIL import Image, ImageDraw

    by_image: Dict[int, List[dict]] = {}
    for a in coco["annotations"]:
        by_image.setdefault(a["image_id"], []).append(a)
    annos, maps = [], {}
    for img in coco["images"]:
        h, w = img["height"], img["width"]
        ids = np.zeros((h, w), np.int64)
        labels = np.full((h, w), 255, np.int64)
        segments = []
        cuts = np.sort(rng.choice(np.arange(1, h), rng.randint(1, 4),
                                  replace=False))
        for y0, y1 in zip([0, *cuts], [*cuts, h]):
            k = rng.randint(N_STUFF)
            sid = len(segments) + 1
            ids[y0:y1] = sid
            labels[y0:y1] = k + 1
            segments.append({"id": sid, "category_id": STUFF_IDS[k],
                             "iscrowd": 0})
        for a in by_image.get(img["id"], []):
            m = Image.new("L", (w, h), 0)
            if a["iscrowd"]:
                rle = a["segmentation"]["counts"]
                flat = np.repeat(np.arange(len(rle)) % 2, rle).astype(bool)
                mask = flat.reshape(w, h).T
                ids[mask], labels[mask] = 0, 255
                continue
            draw = ImageDraw.Draw(m)
            for poly in a["segmentation"]:
                draw.polygon([tuple(p) for p in
                              np.reshape(poly, (-1, 2))], fill=1)
            mask = np.asarray(m, bool)
            sid = len(segments) + 1
            ids[mask], labels[mask] = sid, 0
            segments.append({"id": sid, "category_id": a["category_id"],
                             "iscrowd": 0})
        present = set(np.unique(ids).tolist())
        name = img["file_name"][:-4] + ".png"
        annos.append({"image_id": img["id"], "file_name": name,
                      "segments_info": [s for s in segments
                                        if s["id"] in present]})
        maps[name] = (ids, labels)
    cats = [dict(c, isthing=1) for c in coco["categories"]] + [
        {"id": i, "name": f"stuff{i}", "isthing": 0} for i in STUFF_IDS]
    return {"images": coco["images"], "annotations": annos,
            "categories": cats}, maps


def sem_mapper_cfg():
    """The port's config of the semantic YAML (its training mapper), with
    ``MODEL.ROI_HEADS.NUM_CLASSES`` 80: the mapper's image-level labels
    index by the COCO thing class, and the YAML leaves it at its default
    20, which fails on COCO's classes in both packages."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(SEM_YAML))
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    return cfg


def pillow_sem_canvas(mapper, record: dict, labels: np.ndarray, seed: int):
    """(bucket, canvas): the training ``mapper``'s ``sem_seg`` for the
    record, each resize by Pillow's NEAREST (the JAX mapper's), the
    transforms those ``seed`` draws."""
    from PIL import Image

    from ..data import transforms as T
    from ..data.mapper import pick_bucket

    rng = np.random.RandomState(seed)
    image = np.zeros((record["height"], record["width"], 3), np.uint8)
    image, tfms = T.apply_augmentations(mapper.augmentations, image, rng)
    h, w = image.shape[:2]
    seg = labels.astype(np.uint8)
    for t in tfms.transforms:
        if isinstance(t, T.ResizeTransform):
            seg = np.asarray(Image.fromarray(seg).resize((t.new_w, t.new_h),
                                                         Image.NEAREST))
        elif isinstance(t, T.HFlipTransform):
            seg = seg[:, ::-1]
        elif not isinstance(t, T.NoOpTransform):
            raise TypeError(f"unexpected transform {type(t).__name__}")
    bucket = pick_bucket(h, w, mapper.buckets, mapper.divisibility)
    canvas = np.full((bucket, bucket), mapper.sem_ignore, np.int32)
    canvas[:h, :w] = seg
    return bucket, canvas


def build(seed: int = 0, out: Path = FIXTURE_DIR) -> Dict:
    """Write the fixture files under ``out``; returns the manifest."""
    from PIL import Image

    from ..data.mapper import DatasetMapper
    from . import make_mask_fixtures

    rng = np.random.RandomState(seed)
    files: Dict[str, bytes] = {f"modes/{k}": v
                               for k, v in mode_files(rng).items()}
    rng_wide = np.random.RandomState(seed + 1)
    files.update({f"modes/{k}": v
                  for k, v in wide_files(rng_wide).items()})
    files.update({f"voc/{k}": v for k, v in voc_files(rng_wide).items()})
    coco = make_mask_fixtures.load_manifest()["coco"]
    trees, mapper_entries = {}, []
    mapper = DatasetMapper(sem_mapper_cfg(), is_train=True)
    for split, key in (("train2017", "train"), ("val2017", "test")):
        pan, maps = panoptic_split(coco[key], rng)
        trees[split] = pan
        for name, (ids, labels) in maps.items():
            for sub, arr, mode in ((f"panoptic_{split}", id2rgb(ids), "RGB"),
                                   (f"panoptic_stuff_{split}",
                                    labels.astype(np.uint8), "L")):
                buf = io.BytesIO()
                Image.fromarray(arr, mode).save(buf, "PNG")
                files[f"panoptic/{sub}/{name}"] = buf.getvalue()
        if split == "train2017":
            for i, img in enumerate(coco[key]["images"]):
                s = seed * 1000 + 500 + i
                name = img["file_name"][:-4] + ".png"
                bucket, canvas = pillow_sem_canvas(mapper, img,
                                                   maps[name][1], s)
                mapper_entries.append({"image_id": img["id"], "seed": s,
                                       "bucket": bucket,
                                       "sha256": digest(canvas)})
    for split, key in (("train2017", "train"), ("val2017", "test")):
        files[f"panoptic/annotations/instances_{split}.json"] = json.dumps(
            coco[key], sort_keys=True).encode()
        files[f"panoptic/annotations/panoptic_{split}.json"] = json.dumps(
            trees[split], sort_keys=True).encode()
    manifest = {"seed": seed,
                "files": {k: pillow_decodes(v) for k, v in sorted(
                    files.items()) if k.endswith(".png")},
                "mapper": mapper_entries}
    for rel, data in files.items():
        path = out / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)
    (out / "manifest.json").write_text(json.dumps(manifest, sort_keys=True)
                                       + "\n")
    return manifest


def load_manifest(root: Path = FIXTURE_DIR) -> Dict:
    return json.loads((root / "manifest.json").read_text())


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    manifest = build(args.seed)
    print(f"wrote {len(manifest['files'])} PNG files and "
          f"{len(manifest['mapper'])} mapper canvases under {FIXTURE_DIR}")
    return manifest


if __name__ == "__main__":
    main()
