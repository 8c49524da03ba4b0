"""The port's banded-pool probe (``drn_wsod_torch.tools.pool_banded_probe``)
on the CPU at a toy size: its boxes are the JAX tool's draws, every bucket
runs in order with both paths equal, and it refuses to run without a card
(its times come from CUDA events there; the timer here only counts calls)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from drn_wsod_torch.ops import roi_pool as rp
from drn_wsod_torch.tools import pool_banded_probe as probe

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_pool_banded_probe", ROOT / "tools" / "pool_banded_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_boxes_equal_the_jax_tools_draws():
    """One RandomState(0) drawn across the four buckets in order, as the JAX
    tool draws it: bit-equal boxes at every bucket."""
    jax_tool = _jax_tool()
    ours, theirs = np.random.RandomState(0), np.random.RandomState(0)
    for S in probe.BUCKETS:
        got = probe.boxes_voc_eval(ours, 1, 4096, S)
        want = jax_tool.boxes_voc_eval(theirs, 1, 4096, S)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_bucket_inputs_from_the_seeds():
    rs = np.random.RandomState(0)
    feats, boxes, scale = probe.bucket_inputs(rs, 704, "cpu", P=32, C=8)
    assert feats.shape == (1, 88, 88, 8) and feats.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        boxes.numpy(), probe.boxes_voc_eval(np.random.RandomState(0), 1, 32,
                                            704))
    assert torch.equal(scale, torch.ones(1, 32))
    again = probe.bucket_inputs(np.random.RandomState(0), 704, "cpu", P=32,
                                C=8)
    assert torch.equal(feats, again[0])


@pytest.fixture(scope="module")
def rows():
    calls = []

    def counting_timer(fn, iters):
        for _ in range(iters + 1):
            fn()
        calls.append(iters + 1)
        return float(len(calls))

    before = (rp.roi_pool_batched.launches, dict(rp.roi_pool_banded.launches))
    emitted = []
    out = probe.run(iters=1, device="cpu", P=48, C=8, timer=counting_timer,
                    emit=emitted.append)
    assert emitted == out
    assert (rp.roi_pool_batched.launches,
            rp.roi_pool_banded.launches) == before      # no launch on a CPU
    return out, calls


def test_every_bucket_in_order_and_exact(rows):
    out, calls = rows
    assert [(r.size, r.map) for r in out] == [(704, 88), (1088, 136),
                                              (1280, 160), (1536, 192)]
    assert all(r.max_diff == 0.0 for r in out)
    assert calls == [2] * 8 and all(r.calls == 3 for r in out)
    assert [(r.classic_ms, r.banded_ms) for r in out] == [
        (1.0, 2.0), (3.0, 4.0), (5.0, 6.0), (7.0, 8.0)]


def _cells(box, size, R=7):
    """Cells an RoI's bins cover, bin by bin in plain Python (torchvision's
    integer arithmetic, round half to even on the scaled box)."""
    x1, y1, x2, y2 = (int(np.round(np.float32(v) * np.float32(0.125)))
                      for v in box)

    def axis(start, end):
        roi = max(end - start + 1, 1)
        clamp = lambda v: min(max(v, 0), size)  # noqa: E731
        return sum(max(clamp(-(-(i + 1) * roi // R) + start)
                       - clamp(i * roi // R + start), 0) for i in range(R))

    return axis(x1, x2) * axis(y1, y2)


def test_fractions_follow_both_rules(rows):
    """The JAX tool's short fraction (height / 8 <= 24 cells) beside the
    fraction the band launch takes and its share of the cell reads; the
    boxes are the probe's."""
    out, _ = rows
    rs = np.random.RandomState(0)
    for r in out:
        boxes = probe.boxes_voc_eval(rs, 1, 48, r.size)
        h = (boxes[..., 3] - boxes[..., 1] + 1) / 8.0
        assert r.short_frac == float((h <= 24).mean())
        part = rp.band_partition(torch.from_numpy(boxes), 0.125, r.map)
        assert r.banded_frac == part.short.float().mean().item()
        assert 0.0 < r.banded_frac <= 1.0
        cells = [_cells(b, r.map) for b in boxes[0]]
        short = part.short[0].numpy()
        assert r.banded_reads == pytest.approx(
            sum(c for c, s in zip(cells, short) if s) / sum(cells))
        assert r.reads_gb == pytest.approx(sum(cells) * 8 * 2 / 1e9)
        once = rp.roi_cells(torch.from_numpy(boxes), 0.125, r.map, r.map)
        assert r.cell_reads_gb == pytest.approx(
            once.sum().item() * 8 * 2 / 1e9)
        assert 0.0 < r.cell_reads_gb <= r.reads_gb


def test_lines_carry_the_card():
    row = probe.Bucket(1536, 192, 0.41, 0.40, 0.17, 37.9, 17.0, 18.5, 0.0,
                       12, 30.1)
    lines = probe.format_bucket(row, "[NVIDIA H100 80GB HBM3, 700.00 W]")
    assert len(lines) == 5
    assert all(line.endswith("[NVIDIA H100 80GB HBM3, 700.00 W]")
               for line in lines)
    assert lines[0].startswith("--- bucket 1536 (map 192)")
    assert ("(17.0% of the 37.90 GB of cell reads bin by bin; 30.10 GB "
            "each RoI cell once)") in lines[0]
    assert "17.000 ms (1.77 GB/ms of cell reads)" in lines[1]
    assert "speedup 0.92x" in lines[3]
    assert "max |classic - banded| on the card: 0.0" in lines[4]


def test_probe_refuses_missing_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["--buckets", "704"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.run([704], iters=1)
