"""The one generator of the benchmark's traffic: VOC-shaped records drawn
from a mix file's parameters and a seed.

A record is what the program's packed datasets hold
(``data/record_dataset.py``): decoded BGR pixels under "image", the
proposals with their objectness in descending order, and the annotations
whose classes give the image-level labels. Sizes, classes, boxes and
proposals come from a numpy ``Generator``; the pixels from one draw of a
``torch.Generator`` on ``device``. The same seed gives the same records
on one kind of device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..yardstick import boxes_voc


def image_sizes(mix: dict, n: int, rng: np.random.Generator) -> List[tuple]:
    """(h, w) of ``n`` images: the mix's table of sizes by weight, and its
    "other" share with a long side of ``long_side`` and a short side drawn
    uniformly, either way round."""
    spec = mix["image_sizes"]
    table = spec["table"]
    other = spec["other"]
    weights = np.asarray([w for _, _, w in table] + [other["share"]])
    weights = weights / weights.sum()
    picks = rng.choice(len(weights), size=n, p=weights)
    lo, hi = other["short_side"]
    out = []
    for k in picks:
        if k < len(table):
            out.append((int(table[k][0]), int(table[k][1])))
            continue
        short = int(rng.integers(lo, hi + 1))
        long_side = int(other["long_side"])
        out.append((short, long_side) if rng.random() < 0.5
                   else (long_side, short))
    return out


def image_classes(mix: dict, rng: np.random.Generator) -> List[int]:
    """The classes present in one image: each with the probability of its
    share of the split's images; drawn again until at least one is."""
    spec = mix["class_image_counts"]
    p = np.asarray(spec["counts"], np.float64) / float(spec["images"])
    while True:
        present = np.flatnonzero(rng.random(len(p)) < p)
        if len(present):
            return [int(c) for c in present]


def make_records(mix: dict, seed: int, device, n: int = 0) -> List[dict]:
    """``n`` records (the mix's count where 0) of ``mix`` from ``seed``:
    the sizes from the mix's ``size_seed``, the rest from ``seed``."""
    n = n or int(mix["records"])
    # every seed gets the same sizes (the mix's own seed), so that a run's
    # work does not move with its seed
    sizes = image_sizes(mix, n, np.random.default_rng(mix["size_seed"]))
    rng = np.random.default_rng(seed)
    lo_b, hi_b = mix["boxes_per_class"]
    lo_p, hi_p = mix["proposals"]
    if mix["proposal_mix"] != "boxes_voc" or mix["objectness"] != "uniform":
        raise ValueError("the generator draws boxes_voc proposals with "
                         "uniform objectness")
    records = []
    for i, (h, w) in enumerate(sizes):
        annos = []
        for c in image_classes(mix, rng):
            for _ in range(int(rng.integers(lo_b, hi_b + 1))):
                bw = float(rng.uniform(0.1, 1.0)) * (w - 1)
                bh = float(rng.uniform(0.1, 1.0)) * (h - 1)
                x1 = float(rng.uniform(0, w - 1 - bw))
                y1 = float(rng.uniform(0, h - 1 - bh))
                annos.append({"category_id": c, "difficult": 0,
                              "bbox": [x1, y1, x1 + bw, y1 + bh]})
        P = int(rng.integers(lo_p, hi_p + 1))
        # the 704 px frame of boxes_voc, scaled to the image
        boxes = boxes_voc(rng, 1, P, 704)[0]
        boxes[:, 0::2] *= (w - 1) / 703.0
        boxes[:, 1::2] *= (h - 1) / 703.0
        logits = np.sort(rng.uniform(0, 1, P).astype(np.float32))[::-1]
        records.append({
            "file_name": f"{mix['split']}/{i:06d}.jpg",
            "image_id": f"{i:06d}", "height": h, "width": w,
            "annotations": annos,
            "proposal_boxes": boxes.astype(np.float32),
            "proposal_objectness_logits": logits.copy()})
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(2 ** 62)))
    total = sum(h * w * 3 for h, w in sizes)
    pixels = torch.randint(0, 256, (total,), generator=gen, device=device,
                           dtype=torch.uint8).cpu().numpy()
    at = 0
    for r, (h, w) in zip(records, sizes):
        r["image"] = pixels[at:at + h * w * 3].reshape(h, w, 3)
        at += h * w * 3
    return records
