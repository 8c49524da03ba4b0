"""Probe of the banded RoIPool (counterpart of the JAX package's
``tools/pool_banded_probe.py``): does pooling short RoIs from bands of map
rows staged in shared memory (K3) pay against the batched kernel (K1) at the
large eval buckets, where one image's map outgrows the 50 MB L2?

    python -m drn_wsod_torch.tools.pool_banded_probe [--buckets 704,1088,1280,1536] [--iters N]

Runs on one CUDA device. Per bucket S: B=1, P=4096 proposals from the JAX
tool's VOC-like eval mix (``boxes_voc_eval``, one ``RandomState(0)`` drawn
across the buckets in order, so the boxes equal the JAX tool's), a random
(S/8, S/8, 2048) bf16 map from a seeded ``torch.Generator`` (the JAX tool's
``jax.random`` map cannot be reproduced), roi_scale of ones. It reports the
short-RoI fraction by the JAX tool's rule (height / 8 <= 24 cells), the
fraction the band launch takes (``band_partition``) and its share of the
cell reads (every bin's cells times the channels, ``bin_cells``: what K3 can
move off K1's reads), the reads of a pool that reads each RoI cell once
(``roi_cells``: what K1's body reads), the device ms of
``roi_pool_batched`` (classic, K1) and of ``roi_pool_batched(...,
allow_banded=True)`` (banded, K3) by CUDA events, the speedup, and
``max |classic - banded|``, which must be 0: the tool exits 1 otherwise.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from drn_wsod_torch.tools.ablate_bench import card, cuda_ms

BUCKETS = (704, 1088, 1280, 1536)


def boxes_voc_eval(rs, B, P, img_hw):
    """VOC selective-search-like mix in EVAL view coordinates: log-normal
    side lengths with median ~56px at a 375px source image, scaled up by
    the view's resize factor (a copy of the JAX tool's, same draws)."""
    scale = img_hw / 375.0
    med = 56.0 * scale
    w = np.exp(rs.normal(np.log(med), 0.9, (B, P))).astype(np.float32)
    h = np.exp(rs.normal(np.log(med), 0.9, (B, P))).astype(np.float32)
    w = np.clip(w, 8, img_hw - 1)
    h = np.clip(h, 8, img_hw - 1)
    x1 = rs.uniform(0, 1, (B, P)).astype(np.float32) * (img_hw - 1 - w)
    y1 = rs.uniform(0, 1, (B, P)).astype(np.float32) * (img_hw - 1 - h)
    return np.stack([x1, y1, x1 + w, y1 + h], -1)


def bucket_inputs(rs, S: int, device, P: int = 4096, C: int = 2048):
    """One bucket's (features (1, S/8, S/8, C) bf16, boxes (1, P, 4),
    roi_scale ones (1, P)); draws the boxes from ``rs``."""
    Hf = S // 8
    gen = torch.Generator(device=device).manual_seed(0)
    feats = torch.randn(1, Hf, Hf, C, device=device, generator=gen).to(
        torch.bfloat16)
    boxes = torch.from_numpy(boxes_voc_eval(rs, 1, P, S)).to(device)
    return feats, boxes, torch.ones(1, P, device=device)


@dataclasses.dataclass
class Bucket:
    size: int
    map: int
    short_frac: float      # the JAX tool's rule: height / 8 <= 24 cells
    banded_frac: float     # RoIs the band launch pools (band_partition)
    banded_reads: float    # the band launch's share of the cell reads
    reads_gb: float        # cell reads of one pool: cells x C x 2 bytes
    classic_ms: float
    banded_ms: float
    max_diff: float
    calls: int             # calls of each path, warm-up and compare included
    cell_reads_gb: float   # each RoI's clamped cells once (K1): x C x 2 B

    @property
    def speedup(self) -> float:
        return self.classic_ms / self.banded_ms


def run(buckets: Sequence[int] = BUCKETS, iters: int = 10, device=None,
        P: int = 4096, C: int = 2048,
        timer: Callable[[Callable[[], object], int], float] = cuda_ms,
        emit: Optional[Callable[[Bucket], None]] = None) -> List[Bucket]:
    """Probe each bucket in order; ``device`` is CUDA unless the caller
    names another; ``timer(fn, iters)`` returns ms per call and makes one
    warm-up call plus ``iters`` calls."""
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.ops.roi_pool import (band_partition, bin_cells,
                                             roi_cells, roi_pool_batched)

    dev = resolve_device(device)
    rs = np.random.RandomState(0)
    out = []
    for S in buckets:
        feats, boxes, scale = bucket_inputs(rs, S, dev, P, C)
        hcells = (boxes[..., 3] - boxes[..., 1] + 1).cpu().numpy() / 8.0
        part = band_partition(boxes, 0.125, feats.shape[1])
        cells = bin_cells(boxes, 0.125, feats.shape[1], feats.shape[2])
        total = cells.sum().item()
        nbytes = C * feats.element_size() / 1e9
        once = roi_cells(boxes, 0.125, feats.shape[1], feats.shape[2])

        def classic():
            return roi_pool_batched(feats, boxes, 0.125, 7, scale)

        def banded():
            return roi_pool_batched(feats, boxes, 0.125, 7, scale,
                                    allow_banded=True)

        t_c, t_b = timer(classic, iters), timer(banded, iters)
        diff = (classic().float() - banded().float()).abs().max().item()
        row = Bucket(S, feats.shape[1], float((hcells <= 24).mean()),
                     part.short.float().mean().item(),
                     cells[part.short].sum().item() / total,
                     total * nbytes, t_c, t_b, diff, iters + 2,
                     once.sum().item() * nbytes)
        out.append(row)
        if emit is not None:
            emit(row)
        del feats
    return out


def format_bucket(row: Bucket, tag: str) -> List[str]:
    return [
        f"--- bucket {row.size} (map {row.map}): short-roi (<=24 cells) "
        f"fraction {row.short_frac:.0%}, band launch {row.banded_frac:.0%} "
        f"({row.banded_reads:.1%} of the {row.reads_gb:.2f} GB of cell "
        f"reads bin by bin; {row.cell_reads_gb:.2f} GB each RoI cell once) "
        f"{tag}",
        f"  {'classic (K1, roi_pool_batched)':50s} {row.classic_ms:8.3f} ms "
        f"({row.cell_reads_gb / row.classic_ms:.2f} GB/ms of cell reads) "
        f"{tag}",
        f"  {'banded (K3, 48-row bands + tall rest)':50s} "
        f"{row.banded_ms:8.3f} ms {tag}",
        f"  speedup {row.speedup:.2f}x {tag}",
        f"  max |classic - banded| on the card: {row.max_diff} {tag}"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--buckets", default=",".join(map(str, BUCKETS)),
                    help="comma list of eval image sizes")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls per path, after one warm-up call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pool_banded_probe: no CUDA device; the probe times the card",
              file=sys.stderr)
        return 1
    tag = f"[{card()}]"
    rows = run([int(s) for s in args.buckets.split(",")], args.iters,
               emit=lambda r: print("\n".join(format_bucket(r, tag)),
                                    flush=True))
    return 0 if all(r.max_diff == 0.0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
