"""The readings a cell's limits are set from, and the verdict of the cell's
own comparison on each, in one process on the chip:

    python3 -m h100_bench.calibrate --workload NAME --seeds S1,S2,... \\
        [--variant-seeds 3]

For every seed, ``run.run_cell`` runs the cell's set-up and the part of a
run that the check compares (a training cell's first three steps, no
window; the TTA cell's first images, one after another), and judges the
reference's readings of the program by the cell's limits
(``limits/<cell>.json``). On the first ``--variant-seeds`` seeds it also
reads and judges the control (the reference in float8 in the program's
place) and the planted faults: for training, half of each batch left out
(the mean over the rest; a state left unchanged reads 1 on ``change_gap``
by construction); for TTA, every other view left out and an answer
altered. One JSON line a seed, with each variant's ``correct``; then, for
each variant, on how many seeds it came out correct, and the largest
program reading and the smallest control and fault readings of each
number.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import traceback

from h100_bench import harness
from h100_bench.run import run_cell

VARIANTS = {"train": ("program", "control", "half"),
            "tta_eval": ("program", "control", "half", "altered")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variant-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_env())
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    bench = harness.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    every = VARIANTS[harness.load_mix(cell["traffic"])["driver"]]
    table, verdicts = {}, {}
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        variants = every if n < args.variant_seeds else ("program",)
        judged, setup_s = run_cell(args.workload, seed, 0.0, False, "cuda:0",
                                   variants=variants)
        print(json.dumps({
            "seed": seed, "setup_s": setup_s,
            "correct": {v: ok for v, (ok, _, _) in judged.items()},
            "readings": {v: r for v, (_, _, r) in judged.items()}}),
            flush=True)
        for v, (ok, _, r) in judged.items():
            verdicts.setdefault(v, []).append(bool(ok))
            for k, x in r.items():
                if not k.startswith("_"):
                    table.setdefault((v, k), []).append(x)
        del judged
        gc.collect()
        torch.cuda.empty_cache()
    summary = {f"{v}.{k}": {"max" if v == "program" else "min":
                            max(x) if v == "program" else min(x), "n": len(x)}
               for (v, k), x in table.items()}
    correct = {v: f"{sum(oks)} of {len(oks)} seeds correct"
               for v, oks in verdicts.items()}
    print(json.dumps({"summary": summary, "correct": correct,
                      "card": harness.card(torch.device("cuda:0"), 1)}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except BaseException:  # noqa: BLE001 - reported, then the process ends
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
