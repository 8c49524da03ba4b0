"""The training step's model FLOPs (forward and the backward products the
update needs) over the device's busy time in the traced sub-window (the
union of its operation intervals), as a share of the H100's dense
bfloat16 peak. (``common.py``)"""

from pathlib import Path

from h100_bench.harness import load_module

_common = load_module(Path(__file__).with_name("common.py"),
                      "h100_bench_metric_common")


def read(ctx):
    return _common.mfu_busy(ctx, "train")
