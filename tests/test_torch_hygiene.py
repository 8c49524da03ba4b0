"""The port stands alone: no module of ``drn_wsod_torch`` (its ``tools``
included, nor ``chip_smoke.py``) imports JAX, flax, optax or the JAX
package, and its entry points refuse to fall back to the CPU silently."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import drn_wsod_torch
from test_torch_common import TOY, cfg_pair

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "drn_wsod_tpu")
SOURCES = sorted(str(p.relative_to(ROOT))
                 for p in (ROOT / "drn_wsod_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_no_jax(source):
    bad = sorted(set(_imported_roots(ROOT / source)) & set(FORBIDDEN))
    assert not bad, f"{source} imports {bad}"


def test_import_pulls_in_no_jax():
    code = ("import sys, drn_wsod_torch, drn_wsod_torch.ops._build, "
            "drn_wsod_torch.ops.narrow_max, "
            "drn_wsod_torch.tools.ablate_bench, "
            "drn_wsod_torch.tools.pool_banded_probe, "
            "drn_wsod_torch.tools.mosaic_dtype_probe, "
            "drn_wsod_torch.tools.train_net; "
            "print(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfg_pair(*TOY)
    with pytest.raises(RuntimeError, match="CUDA"):
        drn_wsod_torch.build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        drn_wsod_torch.synthetic_batch(1, 64, 64, 8, 20)
    model = drn_wsod_torch.build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        drn_wsod_torch.make_detect_fn(model, 1e-5, 0.3, 10)


def test_eval_entry_points_refuse_missing_cuda(monkeypatch):
    from drn_wsod_torch.tools import train_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfg_pair(*TOY, "TEST.AUG.ENABLED", True)
    model = drn_wsod_torch.build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        drn_wsod_torch.GeneralizedRCNNWithTTAAVG(cfg, model)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net.do_test(cfg, model)
    args = train_net.argument_parser().parse_args(["--eval-only"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net.main(args)


def test_tools_are_covered():
    for tool in ("ablate_bench", "pool_banded_probe", "mosaic_dtype_probe",
                 "train_net"):
        assert f"drn_wsod_torch/tools/{tool}.py" in SOURCES
    assert "drn_wsod_torch/ops/narrow_max.py" in SOURCES


def test_ablate_bench_refuses_missing_cuda(monkeypatch, capsys):
    from drn_wsod_torch.tools import ablate_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ablate_bench.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        ablate_bench.run(1)
