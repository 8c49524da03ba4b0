"""The control is told apart from the program: the plain reference put in
the program's place and computed in float8 (the step below the
configuration's bfloat16) reads at least three times what the program
reads on one of the cell's numbers, on three seeds, at the small size on
the CPU, where the program passes the cell's limits. The small size's
readings are not the cell's, so its limits cannot judge the control here:
on the chip, at the cells' own sizes, ``python3 -m h100_bench.calibrate``
judges the control and the faults by the limits (PERF.md)."""

import pytest

from h100_bench import harness
from h100_bench.run import run_cell
from h100_bench.small import RECORDS, SMALL

SEEDS = (101, 102, 103)


@pytest.mark.parametrize("workload", ["oicr_r50.train_voc07",
                                      "pcl_r50.train_voc07",
                                      "oicr_r50.tta_eval_voc07"])
def test_control_is_not_correct(workload):
    limits = harness.load_limits(workload)
    for seed in SEEDS:
        judged, _ = run_cell(workload, seed, 0.0, False, "cpu", extra=SMALL,
                             n_records=RECORDS,
                             variants=("program", "control"))
        (ok, _, prog), (_, _, ctrl) = judged["program"], judged["control"]
        assert ok, prog
        ratio = max(ctrl[k] / prog[k] for k in limits if prog[k] > 0)
        assert ratio >= 3.0, (prog, ctrl)
