"""The TTA evaluation's model FLOPs (the forward of every view of every
image) over the untraced sub-window, as a share of that time at the
H100's dense bfloat16 peak. (``common.py``)"""

from pathlib import Path

from h100_bench.harness import load_module

_common = load_module(Path(__file__).with_name("common.py"),
                      "h100_bench_metric_common")


def read(ctx):
    return _common.mfu(ctx, "eval")
