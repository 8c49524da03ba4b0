"""One TTA-AVG image split by bucket group: the host's view build and
upload against the card's scoring (counterpart of the JAX package's
``tools/tta_probe.py``).

    python -m drn_wsod_torch.tools.tta_probe [--iters 3]
        [--config-file CONFIG] [KEY VALUE ...]

The config's model (the flagship YAML by default: 8 scales x flip, MAX
4000) from seeded random weights on one 500x375 image and
``BATCH_SIZE_PER_IMAGE`` proposals drawn as the JAX tool draws them
(``np.random.RandomState(0)``: the pixels, then x1, y1, widths, heights
and objectness; class 3 present). The views (``tta.enumerate_views``) are
grouped by bucket as ``GeneralizedRCNNWithTTAAVG.groups`` groups them. For
each group, in bucket order:

* the host build of its views (``tta.build_view_batch``: the resize on
  the host in numpy, as with ``TEST.AUG.DEVICE_VIEWS`` off) and their
  upload, to the copy's end, by the host clock;
* the card's scoring of the group (the TTA scorer: ``inference_scores``
  and the inverse box maps), by ``benchmark.timed_ms`` (one warm-up
  call, then ``iters`` calls; CUDA events on the card, the host clock
  elsewhere), and the ms a view.

The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .benchmark import sync


@dataclasses.dataclass
class GroupRow:
    bucket: int
    views: int
    host_ms: float        # build + upload, host clock
    image_mb: float       # the group's float32 view images
    score_ms: float       # the card's scoring of the group
    ms_per_view: float


def probe_image(P: int, num_classes: int):
    """The JAX tool's image and proposals: (image (375, 500, 3) uint8,
    proposals (P, 4), objectness (P,), labels (C,))."""
    rs = np.random.RandomState(0)
    H, W = 375, 500
    image = rs.randint(0, 255, (H, W, 3), np.uint8)
    x1 = rs.uniform(0, 400, P).astype(np.float32)
    y1 = rs.uniform(0, 300, P).astype(np.float32)
    bw = rs.uniform(8, 100, P).astype(np.float32)
    bh = rs.uniform(8, 75, P).astype(np.float32)
    props = np.stack([x1, y1, x1 + bw, y1 + bh], 1)
    obj = rs.uniform(0, 1, P).astype(np.float32)
    labels = np.zeros((num_classes,), np.float32)
    labels[3] = 1.0
    return image, props, obj, labels


def run(cfg=None, iters: int = 3, device=None,
        emit: Optional[Callable[[GroupRow], None]] = None) -> List[GroupRow]:
    """One row a bucket group, in bucket order; ``cfg`` None is the
    flagship YAML."""
    import drn_wsod_torch
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.tools.ablate_bench import flagship_cfg
    from drn_wsod_torch.tools.benchmark import timed_ms
    from drn_wsod_torch.tta import (GeneralizedRCNNWithTTAAVG,
                                    build_view_batch)

    dev = resolve_device(device)
    cfg = flagship_cfg() if cfg is None else cfg
    P = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    gen = torch.Generator(device=dev).manual_seed(0)
    model = drn_wsod_torch.build_model(cfg, device=dev, generator=gen)
    tta = GeneralizedRCNNWithTTAAVG(cfg, model, device=dev)
    image, props, obj, labels = probe_image(
        P, cfg.MODEL.ROI_HEADS.NUM_CLASSES)
    rows = []
    for bucket, views in sorted(tta.groups(image.shape[:2]).items()):
        sync(dev)
        t0 = time.perf_counter()
        batch, inv = build_view_batch(
            image, props, obj, labels, tta.min_sizes, tta.max_size,
            tta.flip, tta.buckets, P, views=views)
        batch = batch.to(dev)
        inv = {k: v.to(dev) for k, v in inv.items()}
        sync(dev)
        host_ms = (time.perf_counter() - t0) * 1e3
        score_ms = timed_ms(lambda: tta._score(batch, inv), iters, dev)
        row = GroupRow(bucket, len(views), host_ms,
                       batch.image.numel() * 4 / 2 ** 20, score_ms,
                       score_ms / len(views))
        rows.append(row)
        if emit is not None:
            emit(row)
        del batch, inv
    return rows


def format_row(row: GroupRow, tag: str) -> List[str]:
    return [f"host build+upload bucket {row.bucket} (V={row.views}): "
            f"{row.host_ms:9.3f} ms ({row.image_mb:.0f} MB images) {tag}",
            f"device score bucket {row.bucket} (V={row.views}): "
            f"{row.score_ms:9.3f} ms ({row.ms_per_view:.3f} ms/view) {tag}"]


def main(argv=None, device=None) -> dict:
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.tools.ablate_bench import FLAGSHIP, flagship_cfg
    from drn_wsod_torch.tools.benchmark import card_tag

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=3,
                    help="timed scoring calls a group, after one warm-up")
    ap.add_argument("--config-file", default=FLAGSHIP)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    tag = card_tag(dev)
    rows = run(flagship_cfg(args.config_file, args.opts), args.iters, dev,
               emit=lambda r: print("\n".join(format_row(r, tag)),
                                    flush=True))
    result = {"tool": "tta_probe", "card": tag[1:-1],
              "groups": [dataclasses.asdict(r) for r in rows],
              "host_ms": sum(r.host_ms for r in rows),
              "score_ms": sum(r.score_ms for r in rows)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
