"""What the per-layer readers share, each a reading of one kind of run
("train" or "eval"); a reader that finds nothing to read returns None.

* ``k1_roofline``: K1's share of its roofline over the traced sub-window:
  the sum of the frozen ``roi_pool_bound`` over K1's calls, each on the
  map, boxes and scales that call was handed, over the sum of K1's kernel
  time from the profiler, found by the kernel's name;
* ``mfu``: the model FLOPs of the untraced sub-window
  (``h100_bench/flops.py``) over its time at the H100's dense bfloat16
  peak;
* ``mfu_busy``: the model FLOPs of the traced sub-window over the union
  of the device's operation intervals there, at the same peak: the step's
  share of the peak while the device is busy, which the host's pace does
  not move;
* ``device_idle_share``: 1 - (the union of the device's operation
  intervals a step or image in the traced sub-window) / (the time a step
  or image of the untraced sub-window).
"""

import sys

import torch

from h100_bench.yardstick import PEAK_BF16_FLOP_S, roi_pool_bound

KERNEL = "batched_kernel"


def k1_roofline(ctx, kind):
    if ctx.get("kind") != kind:
        return None
    times = ctx["trace"].by_name(KERNEL)
    calls = ctx["k1_calls"]
    if not times:
        return None
    if len(times) != len(calls):
        print(f"k1_roofline: {len(times)} kernels traced against "
              f"{len(calls)} calls handed in; not read", file=sys.stderr)
        return None
    bound_ms = 0.0
    for c in calls:
        b, m, C, R = c["batch"], c["map"], c["channels"], c["resolution"]
        P = c["boxes"].shape[1]
        dt = getattr(torch, c["dtype"])
        meta = dict(device="meta")
        bound_ms += roi_pool_bound(
            torch.empty(b, m, m, C, dtype=dt, **meta), c["boxes"],
            torch.empty(b, P, dtype=torch.float32, **meta),
            torch.empty(b, P, R, R, C, dtype=dt, **meta),
            c["spatial_scale"])[0]
    return 100.0 * bound_ms * 1e-3 / sum(times)


def mfu(ctx, kind):
    if ctx.get("kind") != kind or not ctx["untraced_s"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["untraced_s"] * PEAK_BF16_FLOP_S)


def mfu_busy(ctx, kind):
    if ctx.get("kind") != kind or not ctx["traced_n"]:
        return None
    busy = ctx["trace"].busy_s()
    if busy <= 0:
        return None
    return 100.0 * ctx["traced_flops"] / (busy * PEAK_BF16_FLOP_S)


def device_idle_share(ctx, kind):
    if ctx.get("kind") != kind or not ctx["traced_n"]:
        return None
    busy = ctx["trace"].busy_s() / ctx["traced_n"]
    return 100.0 * (1.0 - busy / (ctx["untraced_s"] / ctx["untraced_n"]))
