"""A run's modules load neither JAX nor the JAX package, and the reference
loads nothing of the program: each checked in a fresh interpreter, by
whole top-level module names. Whatever loads one all the same, at any
point before the result's line, keeps that line from being printed."""

import subprocess
import sys

import pytest

from h100_bench import harness

CHECK = """
import sys
{imports}
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & {forbidden!r}))
"""


def _loaded(imports, forbidden):
    code = CHECK.format(imports=imports, forbidden=set(forbidden))
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_harness_loads_no_jax():
    imports = "\n".join([
        "import h100_bench.run, h100_bench.calibrate, h100_bench.trace",
        "from h100_bench import harness",
        "for d in ('train', 'tta_eval'): harness.driver(d)",
        "for m in harness.load_benchmark()['per_layer']:",
        "    harness.metric_reader(m['name'])",
        "import drn_wsod_torch.tools.train_net, drn_wsod_torch.tta",
    ])
    assert _loaded(imports, harness.FORBIDDEN) == "[]"


def test_reference_loads_nothing_of_the_program():
    imports = ("import h100_bench.reference.model, h100_bench.check, "
               "h100_bench.flops, h100_bench.yardstick")
    assert _loaded(imports, ("drn_wsod_torch",) + harness.FORBIDDEN) == "[]"


EMIT = """
import sys, types
from h100_bench import harness
for name in {names!r}:
    sys.modules[name] = types.ModuleType(name)
harness.emit({{"correct": True}}, [])
"""


@pytest.mark.parametrize("names", [(), ("jax", "jax.numpy"), ("flax.linen",),
                                   ("drn_wsod_tpu.ops",)])
def test_no_result_where_jax_is_loaded(names):
    out = subprocess.run([sys.executable, "-c", EMIT.format(names=names)],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    if not names:
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip().splitlines()[-1].startswith("{")
    else:
        assert out.returncode != 0 and out.stdout == ""
        assert names[0].split(".")[0] in out.stderr
