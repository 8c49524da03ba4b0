"""The device's idle share in training, a step at a time. (``common.py``)"""

from pathlib import Path

from h100_bench.harness import load_module

_common = load_module(Path(__file__).with_name("common.py"),
                      "h100_bench_metric_common")


def read(ctx):
    return _common.device_idle_share(ctx, "train")
