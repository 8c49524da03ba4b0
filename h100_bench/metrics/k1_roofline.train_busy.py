"""K1 (``ops/roi_pool.py`` -> ``ops/csrc/roi_pool.cu``) in training, in a
cell whose end-to-end speed is the device's busy time an image: its bound
over its kernel time in the traced sub-window. (``common.py``)"""

from pathlib import Path

from h100_bench.harness import load_module

_common = load_module(Path(__file__).with_name("common.py"),
                      "h100_bench_metric_common")


def read(ctx):
    return _common.k1_roofline(ctx, "train")
