"""A cell's traced run (``run.py --trace 1``) with the program's recorder
(``drn_wsod_torch/utils/tracing.py``) on for the traced sub-window alone,
and what ``spans.py`` reads from it:

    python3 -m h100_bench.span_probe --workload NAME --seed N --seconds S \\
        [--out PATH]

It prints the run's result line as ``run.py`` prints it, then one line of
JSON: the breakdown's ``device_by_span``, ``idle_by_span`` and
``counters``; the shares of the device's busy time and of its idle time
that fall inside named spans; the longest idle gaps, each with the runtime
call at its start and that call's thread; the share of device operations
whose launching thread was matched to a thread of the spans; the spans a
step or image; and the readings of ``spans.READINGS``. With ``--out`` the
JSON goes to that file too.

The drivers open the traced sub-window with ``trace.profiler()``; the probe
hands them one that turns the recorder on once the profile has started and
off before it stops. Nothing else of the run changes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

from h100_bench import harness
from h100_bench import spans as spans_lib

UNIT = {"train": "train.step", "eval": "tta.image"}


def probe(workload: str, seed: int, seconds: float, device, extra=None,
          n_records: int = 0):
    """(result, checks, the probe's readings) of one traced run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from drn_wsod_torch.utils import tracing
    from h100_bench import trace
    from h100_bench.run import run_cell

    made = []

    class Recording(profile):
        def start(self):
            super().start()
            tracing.enable()

        def stop(self):
            tracing.disable()
            super().stop()

    def recording():
        made.append(Recording(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]))
        return made[-1]

    plain = trace.profiler
    trace.profiler = recording
    try:
        result, checks = run_cell(workload, seed, seconds, True, device,
                                  extra=extra, n_records=n_records)
    finally:
        trace.profiler = plain
        tracing.disable()
    spans, counters = tracing.drain()
    bench = harness.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    kind = "train" if harness.load_mix(cell["traffic"])["driver"] == "train" \
        else "eval"
    ops, calls = ([], []) if not made else spans_lib.kineto_rows(
        made[-1].profiler.kineto_results.events(),
        torch.autograd.DeviceType.CUDA)
    ctx = {"kind": kind, "spans": spans, "counters": counters,
           "device_ops": ops}
    units = sum(1 for s in spans if s.name == UNIT[kind])
    out = {"workload": workload, "seed": seed, "kind": kind,
           "readings": {k: f(ctx) for k, f in spans_lib.READINGS.items()},
           **spans_lib.breakdown(ctx),
           "spans": len(spans), "units": units,
           "spans_per_unit": len(spans) / units if units else None,
           "device_ops": len(ops)}
    ln = spans_lib.linked(ctx)
    if ln is not None:
        out.update(busy_named_share=ln.named_share(),
                   idle_named_share=ln.idle_named_share(),
                   launches_matched=ln.matched / len(ops),
                   longest_gaps=ln.longest_gaps(calls))
    return result, checks, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_env())

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: no result", file=sys.stderr)
        return 1
    result, checks, out = probe(args.workload, args.seed, args.seconds,
                                "cuda:0")
    harness.emit(result, checks)
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
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
