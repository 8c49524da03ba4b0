"""One run of one cell of the port's benchmark, in a fresh process:

    python3 -m h100_bench.run --workload NAME --seed N --seconds S --trace 0|1

It finds the cell in ``BENCHMARK.json``, its configuration under
``configs/``, its traffic mix under ``traffic/`` and, by the mix, its driver
under ``drivers/``; loads, warms up and measures for ``--seconds``; checks
what the timed path produced against the plain reference
(``reference/``, ``check.py``, ``limits/<cell>.json``); and prints the result
as the last line of standard output. With ``--trace 1`` the metrics are the
cell's per-layer ones, each read by ``metrics/<name>.py``.

It exits with 1 and prints no result where CUDA is absent or the cell asks
for more cards than there are, and where JAX, flax or the JAX package is
loaded in this process when the result is to be printed (after the window,
the metric readers and the reference). The loader's worker
threads stay blocked on their full queues when training stops (the
program's ``data/loader.py``), so the process ends itself once its result
is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import traceback
from typing import Optional

from h100_bench import harness


@dataclasses.dataclass
class RunContext:
    workload: str
    conf: dict
    mix: dict
    seeds: harness.Seeds
    seconds: float
    trace: bool
    device: object
    n_records: int = 0             # the mix's count where 0
    checks_only: bool = False      # no warm-up and no window (calibration)
    window_busy: bool = False      # an end-to-end metric from the trace

    def program_cfg(self):
        """The program's config: its defaults, given every value of the
        configuration's file."""
        from drn_wsod_torch.config import CfgNode, get_cfg

        cfg = get_cfg()
        cfg.merge_from_other(CfgNode(self.conf["merged"]))
        cfg.freeze()
        return cfg

    def solver(self) -> dict:
        s = self.conf["merged"]["SOLVER"]
        return {"lr": float(s["BASE_LR"]), "momentum": float(s["MOMENTUM"]),
                "weight_decay": float(s["WEIGHT_DECAY"]),
                "bias_lr_factor": float(s["BIAS_LR_FACTOR"]),
                "weight_decay_bias": float(s["WEIGHT_DECAY_BIAS"])}


def cell_metrics(bench: dict, workload: str, trace: bool):
    """The cell's end-to-end metrics (``--trace 0``) or per-layer metrics
    (``--trace 1``): a metric with ``workloads`` names its cells, one
    without applies to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, extra: Optional[dict] = None, n_records: int = 0,
             variants: Optional[tuple] = None):
    """One run of one cell: the result's line and its checks. With
    ``variants`` (calibration: no warm-up and no window), the check alone,
    for each variant that the driver's reference reads ("program", the
    float8 "control", the planted faults): {variant: (correct, checks,
    readings)}, each judged by the cell's own limits."""
    import torch

    from h100_bench.check import judge

    bench = harness.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == cell["config"])
    ctx = RunContext(
        workload=workload,
        conf=harness.load_config(conf_entry["name"], extra),
        mix=harness.load_mix(cell["traffic"]),
        seeds=harness.derive_seeds(seed), seconds=float(seconds),
        trace=bool(trace), device=torch.device(device), n_records=n_records,
        checks_only=variants is not None,
        window_busy=any(m["source"] == "device_trace"
                        for m in cell_metrics(bench, workload, False)))
    out = harness.driver(ctx.mix["driver"]).run(ctx)
    limits = harness.load_limits(workload)
    if variants is not None:
        verdicts = {}
        for v, r in out["reference"](tuple(variants)).items():
            ok, checks = judge(r, limits)
            verdicts[v] = (ok, checks, r)
        return verdicts, out["setup_s"]
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        if m["name"] == "setup_s":
            value = out["setup_s"]
        elif trace:
            value = harness.metric_reader(m["name"])(out)
            if value is None:
                continue
        else:
            value = out["metrics"][m["name"]]
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_block = harness.device_block(ctx.device, cell["chips"],
                                        out.get("memory_peak_bytes", 0))
    result = {"correct": False, "attempted": int(out["attempted"]),
              "failed": int(out.get("failed", 0)), "metrics": metrics,
              "device": device_block}
    if trace:
        tr = out["trace"]
        device_block["busy_s"] = tr.busy_s()
        device_block["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    harness.log("metrics read")
    readings = out["reference"](("program",))["program"]
    harness.log("reference compared")
    correct, checks = judge(readings, limits)
    result["correct"] = bool(correct and result["failed"] == 0)
    result["card"] = harness.card(ctx.device, cell["chips"])
    result["host"] = out.get("host")
    result["readings"] = {k.lstrip("_"): v for k, v in readings.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.update(harness.cache_env())

    import torch

    bench = harness.load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 1
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell needs {chips} CUDA device(s); {found} found: no "
              "result", file=sys.stderr)
        return 1
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0")
    harness.emit(result, checks)
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
