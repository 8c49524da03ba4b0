"""Write the fixtures that hold the port's polygon rasterizer
(``structures/masks.py:fill_polygon``) to Pillow's
(``drn_wsod_torch/data/mask_fixtures/manifest.json``):

    python -m drn_wsod_torch.tools.make_mask_fixtures [--seed 0]

The manifest holds, all made from the seed:

  * "polygons": canvases with polygons of every kind the rasterizer must
    take (convex and concave, self-intersecting, several to a canvas,
    vertices off the canvas, on integers and half-integers, horizontal and
    vertical edges, repeated vertices, two points, zero area), each with
    the sha256 of Pillow's ``ImageDraw.polygon(fill=1)`` of its polygons
    on an "L" image;
  * "coco": a COCO instances json of COCO-sized images (8 train, 2 test;
    1-5 polygon instances an image, some of two polygons, a crowd region
    as uncompressed RLE on each split's first image, each split's last
    image without annotations), the data of
    ``chip_smoke.py``'s Mask R-CNN phase;
  * "mapper": for each train image and a seed of its own, the size bucket
    and the sha256 of each instance's mask as the training mapper of
    ``configs/Misc/mask_rcnn_R_50_FPN_1x.yaml`` makes it (the resize and
    flip that seed draws), each polygon drawn with Pillow.

``tests/test_torch_masks.py`` holds the committed file to a fresh build
(so a stale fixture shows), the port's rasterizer and mapper to its
digests, and the JAX package's mapper too; ``chip_smoke.py`` holds the
port's, on a machine without Pillow. ``synthetic_coco`` also makes the
person keypoint json of the Keypoint R-CNN phase. Needs Pillow.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Dict, List

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parents[1] / "data" / "mask_fixtures"
MASK_YAML = (Path(__file__).resolve().parents[2] / "configs" / "Misc"
             / "mask_rcnn_R_50_FPN_1x.yaml")
# COCO-sized images (height, width)
COCO_SIZES = ((480, 640), (640, 480), (375, 500), (612, 612), (427, 640),
              (640, 427), (480, 640), (333, 500), (480, 640), (500, 375))
NUM_KEYPOINTS = 17


def mask_digest(mask: np.ndarray) -> str:
    """sha256 of an (H, W) mask's bytes as uint8 0/1."""
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(mask).astype(bool), np.uint8).tobytes()).hexdigest()


def _round_to(v: np.ndarray, step: float) -> list:
    return (np.round(v / step) * step).tolist()


def polygon_cases(rng: np.random.RandomState) -> List[dict]:
    """Canvases of polygons ({"height", "width", "polygons"}), a few of
    each kind."""
    cases = []

    def add(h, w, polys):
        cases.append({"height": int(h), "width": int(w),
                      "polygons": [[float(c) for c in np.ravel(p)]
                                   for p in polys]})

    for _ in range(12):                     # random, concave or crossing
        h, w = rng.randint(8, 90, 2)
        n = rng.randint(3, 12)
        add(h, w, [rng.uniform(-0.2, 1.2, (n, 2)) * (w, h)])
    for _ in range(6):                      # star-shaped, many vertices
        h, w = rng.randint(40, 160, 2)
        n = rng.randint(12, 40)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(0.2, 0.5, n) * min(h, w)
        add(h, w, [np.stack([w / 2 + rad * np.cos(ang),
                             h / 2 + rad * np.sin(ang)], -1)])
    for step in (1.0, 0.5):                 # integer / half-integer vertices
        for _ in range(6):
            h, w = rng.randint(8, 60, 2)
            n = rng.randint(3, 9)
            add(h, w, [_round_to(rng.uniform(-5, max(h, w) + 5, (n, 2)),
                                 step)])
    for _ in range(6):                      # rectilinear: runs of edges
        h, w = rng.randint(10, 50, 2)
        n = rng.randint(2, 6)
        xs = np.sort(rng.randint(-3, w + 3, n * 2)).reshape(n, 2)
        pts = [(xs[0, 0], 2), (xs[0, 1], 2)]
        for k in range(1, n):
            pts += [(xs[k, 0], 2 + 4 * k), (xs[k, 1], 2 + 4 * k)]
        add(h, w, [pts + [(xs[-1, 1] + 2, h - 1), (xs[0, 0] - 1, h - 1)]])
    for _ in range(6):                      # two polygons, one off canvas
        h, w = rng.randint(16, 80, 2)
        add(h, w, [rng.uniform(0, 1, (5, 2)) * (w, h),
                   rng.uniform(-0.5, 1.5, (4, 2)) * (w, h)])
    add(20, 20, [[(3, 3), (15, 9)]])                     # two points
    add(20, 20, [[(2, 2), (10, 10), (18, 18)]])          # zero area
    add(20, 20, [[(2, 2), (2, 2), (12, 3), (12, 3), (5, 15)]])  # repeats
    add(20, 24, [[(4.5, 3.5), (20.5, 3.5), (20.5, 16.5), (4.5, 16.5)]])
    add(12, 12, [[(-30, -30), (60, -20), (40, 50)]])     # covers the canvas
    add(12, 12, [[(-8.7, 3.2), (-2.1, 9.9), (-5.5, 14.0)]])  # left of it
    return cases


def _polygon(rng, x0, y0, w, h, n) -> np.ndarray:
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.45, 1.0, n)
    return np.stack([x0 + w / 2 * (1 + rad * np.cos(ang)),
                     y0 + h / 2 * (1 + rad * np.sin(ang))], -1)


def synthetic_coco(seed: int, n_images: int, first_id: int = 1,
                   keypoints: bool = False, num_classes: int = 80) -> dict:
    """A COCO instances json (dict) of ``n_images`` COCO-sized images.

    Masks (``keypoints`` False): ``num_classes`` categories (ids 1..C);
    each image has 1-5 polygon instances (a third of them of two polygons)
    with ``area`` their polygons' shoelace area, the first image also a
    crowd region as uncompressed RLE of its last instance's category, and
    the last image no annotation.
    Keypoints: one "person" category; 1-4 people an image, 17 keypoints
    each (visibility 0, 1 or 2; 0 at (0, 0), as COCO writes it), one
    person in four with none labelled."""
    rng = np.random.RandomState(seed)
    images, annos = [], []
    for k in range(n_images):
        h, w = COCO_SIZES[(seed + k) % len(COCO_SIZES)]
        iid = first_id + k
        images.append({"id": iid, "file_name": f"{iid:012d}.jpg",
                       "height": h, "width": w})
        if k == n_images - 1 and not keypoints and n_images > 1:
            continue                        # an image without annotations
        for _ in range(rng.randint(1, 5 if keypoints else 6)):
            bw, bh = rng.uniform(0.1, 0.6) * w, rng.uniform(0.1, 0.6) * h
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            polys = [_polygon(rng, x0, y0, bw, bh, rng.randint(5, 16))]
            if not keypoints and rng.rand() < 1 / 3:
                polys.append(_polygon(rng, x0 + bw * 0.1, y0 + bh * 0.1,
                                      bw * 0.3, bh * 0.3, 4))
            pts = np.concatenate(polys)
            x1, y1 = pts.min(0)
            x2, y2 = pts.max(0)
            area = sum(0.5 * abs(np.dot(p[:, 0], np.roll(p[:, 1], -1))
                                 - np.dot(p[:, 1], np.roll(p[:, 0], -1)))
                       for p in polys)
            a = {"id": len(annos) + 1, "image_id": iid, "iscrowd": 0,
                 "category_id": 1 if keypoints
                 else int(rng.randint(1, num_classes + 1)),
                 "bbox": [float(x1), float(y1), float(x2 - x1),
                          float(y2 - y1)],
                 "area": float(area),
                 "segmentation": [[round(float(c), 2) for c in p.ravel()]
                                  for p in polys]}
            if keypoints:
                kp = np.zeros((NUM_KEYPOINTS, 3))
                if rng.rand() >= 0.25:
                    vis = rng.randint(0, 3, NUM_KEYPOINTS)
                    vis[rng.randint(NUM_KEYPOINTS)] = 2
                    kp[:, 0] = rng.uniform(x1, x2, NUM_KEYPOINTS)
                    kp[:, 1] = rng.uniform(y1, y2, NUM_KEYPOINTS)
                    kp[:, 2] = vis
                    kp[vis == 0, :2] = 0
                a["keypoints"] = [round(float(c), 2) for c in kp.ravel()]
                a["num_keypoints"] = int((kp[:, 2] > 0).sum())
            annos.append(a)
        if k == 0 and not keypoints:
            # a crowd region as uncompressed RLE: a band of rows
            m = np.zeros((h, w), bool)
            m[h // 3:h // 2, w // 4:3 * w // 4] = True
            flat = m.T.reshape(-1)
            runs = np.diff(np.concatenate(
                [[0], np.flatnonzero(flat[1:] != flat[:-1]) + 1,
                 [flat.size]])).tolist()
            annos.append({"id": len(annos) + 1, "image_id": iid,
                          "iscrowd": 1,
                          "category_id": annos[-1]["category_id"],
                          "bbox": [w // 4, h // 3, w // 2, h // 2 - h // 3],
                          "area": float(m.sum()),
                          "segmentation": {"size": [h, w],
                                           "counts": [int(r) for r in runs]}})
    if keypoints:
        cats = [{"id": 1, "name": "person",
                 "keypoints": [f"kp{i}" for i in range(NUM_KEYPOINTS)]}]
    else:
        cats = [{"id": c, "name": f"class{c}"}
                for c in range(1, num_classes + 1)]
    return {"images": images, "annotations": annos, "categories": cats}


def coco_records(coco: dict) -> List[dict]:
    """The dataset records of a COCO json dict (``load_coco_json`` on a
    temporary copy), each with a zero image of its size in place of the
    pixels, as a packed record carries them."""
    from ..data.datasets.coco import load_coco_json

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "instances.json")
        with open(path, "w") as f:
            json.dump(coco, f)
        records = load_coco_json(path, d)
    for r in records:
        r["image"] = np.zeros((r["height"], r["width"], 3), np.uint8)
    return records


def mask_mapper_cfg():
    """The port's config of the Mask R-CNN YAML (its training mapper)."""
    from ..config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(MASK_YAML))
    return cfg


def pillow_mapper_masks(mapper, record: dict, seed: int):
    """(bucket, [mask per instance]) as the training ``mapper`` places the
    record's instances, each polygon drawn with Pillow (the JAX mapper's
    rasterization): the transforms are the ones ``seed`` draws."""
    from PIL import Image, ImageDraw

    from ..data import transforms as T
    from ..data.mapper import pick_bucket

    rng = np.random.RandomState(seed)
    image, tfms = T.apply_augmentations(mapper.augmentations,
                                        record["image"], rng)
    h, w = image.shape[:2]
    bucket = pick_bucket(h, w, mapper.buckets, mapper.divisibility)
    masks = []
    for a in record["annotations"]:
        if a.get("difficult", 0):
            continue
        m = Image.new("L", (bucket, bucket), 0)
        draw = ImageDraw.Draw(m)
        for poly in a.get("segmentation") or []:
            pts = tfms.apply_coords(np.asarray(poly, np.float32).reshape(-1, 2))
            draw.polygon([tuple(p) for p in pts], fill=1)
        masks.append(np.asarray(m, bool))
    return bucket, masks


def build_manifest(seed: int = 0) -> Dict:
    """The manifest's content (Pillow draws every digest)."""
    from PIL import Image, ImageDraw

    from ..data.mapper import DatasetMapper

    rng = np.random.RandomState(seed)
    cases = polygon_cases(rng)
    for c in cases:
        im = Image.new("L", (c["width"], c["height"]), 0)
        draw = ImageDraw.Draw(im)
        for p in c["polygons"]:
            draw.polygon([tuple(q) for q in np.reshape(p, (-1, 2))], fill=1)
        c["sha256"] = mask_digest(np.asarray(im, bool))
    train = synthetic_coco(seed + 1, 8)
    test = synthetic_coco(seed + 2, 2, first_id=101)
    mapper = DatasetMapper(mask_mapper_cfg(), is_train=True)
    entries = []
    for i, r in enumerate(coco_records(train)):
        s = seed * 1000 + i
        bucket, masks = pillow_mapper_masks(mapper, r, s)
        entries.append({"image_id": r["image_id"], "seed": s,
                        "bucket": bucket,
                        "masks_sha256": [mask_digest(m) for m in masks]})
    return {"seed": seed, "polygons": cases,
            "coco": {"train": train, "test": test}, "mapper": entries}


def load_manifest() -> Dict:
    return json.loads((FIXTURE_DIR / "manifest.json").read_text())


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    manifest = build_manifest(args.seed)
    FIXTURE_DIR.mkdir(parents=True, exist_ok=True)
    path = FIXTURE_DIR / "manifest.json"
    path.write_text(json.dumps(manifest, sort_keys=True) + "\n")
    print(f"wrote {len(manifest['polygons'])} polygon cases and "
          f"{len(manifest['mapper'])} mapper records to {path}")
    return manifest


if __name__ == "__main__":
    main()
