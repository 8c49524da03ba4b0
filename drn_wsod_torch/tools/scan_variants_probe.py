"""The flagship train step issued four ways (counterpart of the JAX
package's ``tools/scan_variants_probe.py``).

    python -m drn_wsod_torch.tools.scan_variants_probe [--k 20]
        [--config-file CONFIG] [--size 704] [--batch 2] [--proposals 4096]
        [KEY VALUE ...]

The JAX tool separates what its ``lax.scan`` of K steps costs: per-step
dispatch, a scan over fresh stacked batches in float32 and in uint8, and a
scan that reuses one batch. The port has no scan; its chunk of K steps is
``make_multi_train_step``, the same launches issued one by one. The four
cases, each K steps from seeded random weights built afresh (the JAX
tool's fresh state) at the bench shape (B=2 704^2 images, P=4096), the
YAML's solver at ``benchmark.PROBE_LR``:

1. ``per_step``: the step called K times on one batch;
2. ``fresh_f32``: one ``multi_step`` call over K batches drawn from seeds
   0..K-1 (``synthetic_batch``), float32 pixels, all on the card before
   the call;
3. ``fresh_u8``: the same batches with uint8 pixels (clipped to 0-255),
   the mapper's format; the model's ``preprocess`` casts them on the
   card;
4. ``reused``: one ``multi_step`` call over one batch K times.

Each is timed by ``benchmark.timed_ms`` (one warm-up call of K steps, then
one timed call; CUDA events on the card, the host clock elsewhere): ms a
step and img/s. The JAX tool's fifth case (K steps unrolled into one jit)
has no meaning without a compiler of the step. The last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable, List, Optional

import torch

CASES = ("per_step", "fresh_f32", "fresh_u8", "reused")


@dataclasses.dataclass
class CaseRow:
    case: str
    ms_per_step: float
    img_per_s: float


def run(cfg=None, k: int = 20, device=None, B: int = 2, S: int = 704,
        P: int = 4096, emit: Optional[Callable[[CaseRow], None]] = None
        ) -> List[CaseRow]:
    """One row a case, in ``CASES`` order; ``cfg`` None is the flagship
    YAML."""
    import drn_wsod_torch
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.tools.ablate_bench import flagship_cfg
    from drn_wsod_torch.tools.benchmark import (PROBE_LR, seeded_train_step,
                                                timed_ms)

    dev = resolve_device(device)
    cfg = flagship_cfg(overrides=PROBE_LR) if cfg is None else cfg
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    fresh = [drn_wsod_torch.synthetic_batch(B, S, S, P, C, seed=i,
                                            device=dev) for i in range(k)]
    rows = []
    for case in CASES:
        step, state = seeded_train_step(cfg, dev)
        multi = drn_wsod_torch.make_multi_train_step(step)
        if case == "per_step":
            def call():
                for _ in range(k):
                    step(state, fresh[0], 0)
        elif case == "reused":
            def call():
                multi(state, [fresh[0]] * k, 0)
        else:
            batches = fresh if case == "fresh_f32" else [
                b.replace(image=b.image.clamp(0, 255).to(torch.uint8))
                for b in fresh]

            def call(batches=batches):
                multi(state, batches, 0)
        ms = timed_ms(call, 1, dev) / k
        row = CaseRow(case, ms, B * 1e3 / ms)
        rows.append(row)
        if emit is not None:
            emit(row)
        del step, state, multi, call
    return rows


def format_row(row: CaseRow, tag: str) -> str:
    return (f"{row.case:10s} {row.ms_per_step:8.3f} ms/step  "
            f"{row.img_per_s:7.2f} img/s {tag}")


def main(argv=None, device=None) -> dict:
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.tools.ablate_bench import FLAGSHIP, flagship_cfg
    from drn_wsod_torch.tools.benchmark import PROBE_LR, card_tag

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=20, help="steps a case")
    ap.add_argument("--config-file", default=FLAGSHIP)
    ap.add_argument("--size", type=int, default=704)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--proposals", type=int, default=4096)
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    tag = card_tag(dev)
    rows = run(flagship_cfg(args.config_file, [*PROBE_LR, *args.opts]),
               args.k, dev, args.batch, args.size, args.proposals,
               emit=lambda r: print(format_row(r, tag), flush=True))
    result = {"tool": "scan_variants_probe", "card": tag[1:-1], "k": args.k,
              "batch": args.batch, "size": args.size,
              "proposals": args.proposals,
              "rows": [dataclasses.asdict(r) for r in rows]}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
