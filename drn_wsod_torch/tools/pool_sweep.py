"""The RoIPool kernels on two box mixes (counterpart of the JAX package's
``tools/pool_sweep.py``): the flagship bench mix, and a VOC-like one.

    python -m drn_wsod_torch.tools.pool_sweep [--iters N] [--size 704]
        [--batch 2] [--proposals 4096] [--channels 2048]

Runs on one CUDA device unless the caller names another. At the flagship
pool's shape (B=2 704x704 images, an (88, 88, 2048) bf16 map drawn from a
seeded ``torch.Generator``, P=4096 RoIs, roi_scale ones), for each mix:

* "uniform": widths and heights uniform in 8..0.4 S (``boxes_uniform``);
* "voc": log-normal sides of median 56 px (``boxes_voc``), a
  selective-search-like mix heavy in small boxes;

both drawn from one ``np.random.RandomState(0)`` in that order, so that the
boxes equal the JAX tool's. It prints the RoIs' shares by clamped map
height, the band launch's short class (``band_partition``: at most 24
rows) among them, where the JAX tool prints its Pallas kernel's tier
histogram; then, each queued (20 calls behind a sleep,
``benchmark.queued_ms``) beside the call's bound (``roi_pool_bound``):
K1 as the model launches it (``roi_pool_batched``, its blocks in the
top-row order), K1 in RoI order (its one launch option off), K3
(``allow_banded=True``) and the plain version, with max |kernel - plain|,
which must be 0 (the tool exits 1 otherwise). The JAX tool's variants
(RB, joint_emit, row_share) are tilings of its Pallas kernel that K1 does
not have, so they are left out. The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# clamped map heights (cells) of the share classes, upper bounds inclusive
HEIGHT_CLASSES = ((8, "<=8"), (24, "9-24"), (48, "25-48"), (None, ">48"))


def boxes_uniform(rs, B, P, S):
    """The flagship bench mix (a copy of the JAX tool's, same draws)."""
    x1 = rs.uniform(0, S * 0.6, (B, P)).astype(np.float32)
    y1 = rs.uniform(0, S * 0.6, (B, P)).astype(np.float32)
    w = rs.uniform(8, S * 0.4, (B, P)).astype(np.float32)
    h = rs.uniform(8, S * 0.4, (B, P)).astype(np.float32)
    return np.stack([x1, y1, np.minimum(x1 + w, S - 1),
                     np.minimum(y1 + h, S - 1)], -1)


def boxes_voc(rs, B, P, S):
    """Selective-search-like: log-normal sides, median 56 px at 704 px
    (a copy of the JAX tool's, same draws)."""
    w = np.exp(rs.normal(np.log(56.0), 0.9, (B, P))).astype(np.float32)
    h = np.exp(rs.normal(np.log(56.0), 0.9, (B, P))).astype(np.float32)
    w = np.clip(w, 8, S - 1)
    h = np.clip(h, 8, S - 1)
    x1 = rs.uniform(0, 1, (B, P)).astype(np.float32) * (S - 1 - w)
    y1 = rs.uniform(0, 1, (B, P)).astype(np.float32) * (S - 1 - h)
    return np.stack([x1, y1, x1 + w, y1 + h], -1)


MIXES = (("uniform", boxes_uniform), ("voc", boxes_voc))


def height_shares(boxes: torch.Tensor, spatial_scale: float,
                  H: int) -> Dict[str, float]:
    """The RoIs' shares by map height clamped to the map
    (``HEIGHT_CLASSES``), and "short": the band launch's class."""
    from drn_wsod_torch.ops.roi_pool import band_partition, map_coords

    _, y1, _, roi_h = map_coords(boxes, spatial_scale)
    h = ((y1 + roi_h).clamp(0, H) - y1.clamp(0, H)).clamp(min=0)
    out, lo = {}, 0
    for hi, name in HEIGHT_CLASSES:
        sel = h > lo if hi is None else (h > lo) & (h <= hi)
        out[name] = sel.float().mean().item()
        lo = hi
    out["short"] = band_partition(boxes, spatial_scale,
                                  H).short.float().mean().item()
    return out


@dataclasses.dataclass
class Sweep:
    mix: str
    shares: Dict[str, float]   # RoI shares by clamped map height
    bound_ms: float            # roi_pool_bound of the call
    bound_by: str
    ms: Dict[str, float]       # variant -> ms a call, queued
    max_diff: Dict[str, float]  # kernel variant -> max |kernel - plain|
    calls: int                 # calls of each variant: compare, warm-up,
                               # timed


def k1_in_roi_order(feats, boxes, scale, spatial_scale=0.125,
                    resolution=7):
    """K1 with its blocks taking each image's RoIs in RoI order; on CPU
    tensors the wrapper's plain version (the order changes no value)."""
    from drn_wsod_torch.ops import roi_pool as rp

    if not feats.is_cuda:
        return rp.roi_pool_batched(feats, boxes, spatial_scale, resolution,
                                   scale)
    rp._check_batched(feats, boxes, scale)
    return rp._launch_batched(feats, boxes, spatial_scale, resolution, scale,
                              rp.roi_order(boxes))


def run(iters: int = 20, device=None, B: int = 2, S: int = 704,
        P: int = 4096, C: int = 2048, timer: Optional[Callable] = None,
        emit: Optional[Callable[[Sweep], None]] = None) -> List[Sweep]:
    """Sweep both mixes in order; ``device`` is CUDA unless the caller
    names another; ``timer(fn, iters)`` returns ms a call after one
    warm-up call (default: ``queued_ms`` on the device)."""
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.ops.roi_pool import (roi_pool_batched,
                                             roi_pool_bound, roi_pool_plain)
    from drn_wsod_torch.tools.benchmark import queued_ms

    dev = resolve_device(device)
    if timer is None:
        def timer(fn, n):
            return queued_ms(fn, n, dev)
    Hf = S // 8
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn(B, Hf, Hf, C, device=dev, generator=gen).to(
        torch.bfloat16)
    scale = torch.ones(B, P, device=dev)
    rs = np.random.RandomState(0)
    out = []
    for mix, draw in MIXES:
        boxes = torch.from_numpy(draw(rs, B, P, S)).to(dev)
        variants = {
            "K1 top-row order": lambda: roi_pool_batched(
                feats, boxes, 0.125, 7, scale),
            "K1 RoI order": lambda: k1_in_roi_order(feats, boxes, scale),
            "K3 banded": lambda: roi_pool_batched(
                feats, boxes, 0.125, 7, scale, allow_banded=True),
            "plain": lambda: roi_pool_plain(feats, boxes, 0.125, 7, scale)}
        want = variants["plain"]()
        diffs = {name: (fn().float() - want.float()).abs().max().item()
                 for name, fn in variants.items() if name != "plain"}
        bound = roi_pool_bound(feats, boxes, scale, want, 0.125)
        del want
        ms = {name: timer(fn, iters) for name, fn in variants.items()}
        row = Sweep(mix, height_shares(boxes, 0.125, Hf), bound[0],
                    bound[1], ms, diffs, iters + 2)
        out.append(row)
        if emit is not None:
            emit(row)
    return out


def format_sweep(row: Sweep, tag: str) -> List[str]:
    shares = " ".join(f"{k}:{v:.1%}" for k, v in row.shares.items()
                      if k != "short")
    lines = [f"--- {row.mix}: RoIs by clamped map height {shares}; band "
             f"launch's short class (<= 24 rows) {row.shares['short']:.1%} "
             f"{tag}"]
    for name, ms in row.ms.items():
        diff = (f", max |kernel - plain| {row.max_diff[name]}"
                if name in row.max_diff else "")
        lines.append(f"  {name:20s} {ms:9.4f} ms queued, "
                     f"{ms / row.bound_ms:6.2f}x the bound{diff} {tag}")
    lines.append(f"  bound {row.bound_ms:.4f} ms ({row.bound_by}) {tag}")
    return lines


def main(argv=None, device=None) -> dict:
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.tools.benchmark import card_tag

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20,
                    help="calls queued per variant, after one warm-up")
    ap.add_argument("--size", type=int, default=704)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--proposals", type=int, default=4096)
    ap.add_argument("--channels", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    tag = card_tag(dev)
    rows = run(args.iters, dev, args.batch, args.size, args.proposals,
               args.channels,
               emit=lambda r: print("\n".join(format_sweep(r, tag)),
                                    flush=True))
    result = {"tool": "pool_sweep", "card": tag[1:-1],
              "mixes": [dataclasses.asdict(r) for r in rows],
              "exact": all(d == 0.0 for r in rows
                           for d in r.max_diff.values())}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["exact"] else 1)
