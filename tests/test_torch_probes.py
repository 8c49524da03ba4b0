"""The port's six performance probes (``drn_wsod_torch/tools/pool_sweep.py``,
``dispatch_probe.py``, ``scan_k_probe.py``, ``scan_variants_probe.py``,
``cli_throughput.py``, ``tta_probe.py``) on the CPU at a toy size: each
``main(device="cpu")`` runs and prints its JSON object as its last line
(no time is claimed here: the probes time the card). ``pool_sweep``'s box
mixes are bit-equal to the JAX tool's, loaded by path, and its kernels
equal their plain version; ``roi_pool_bound`` and the queued timer, moved
from ``chip_smoke.py`` into the package, return what they returned."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from drn_wsod_torch.data import DatasetCatalog, MetadataCatalog
from drn_wsod_torch.ops import roi_pool as rp
from drn_wsod_torch.tools import (benchmark, cli_throughput, dispatch_probe,
                                  pool_sweep, scan_k_probe,
                                  scan_variants_probe, tta_probe)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOY = ["MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
       "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]", "MODEL.DTYPE", "float32"]
SHAPE = ["--size", "64", "--batch", "2", "--proposals", "16"]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


@pytest.fixture
def catalogs_kept():
    """The port's catalogs put back as they were (``train_net.main``
    registers the builtin datasets)."""
    registry = dict(DatasetCatalog._registry)
    metadata = dict(MetadataCatalog._map)
    yield
    DatasetCatalog.clear()
    DatasetCatalog._registry.update(registry)
    MetadataCatalog.clear()
    MetadataCatalog._map.update(metadata)


@pytest.mark.parametrize("S", [704, 200])
def test_pool_sweep_boxes_bit_equal_jax(S):
    """Both mixes from one RandomState(0) in the JAX tool's order."""
    jax_tool = _jax_tool("pool_sweep")
    mine, theirs = np.random.RandomState(0), np.random.RandomState(0)
    for (name, draw), jdraw in zip(pool_sweep.MIXES, (
            jax_tool.boxes_uniform, jax_tool.boxes_voc)):
        assert draw.__name__ == jdraw.__name__ == f"boxes_{name}"
        got, want = draw(mine, 2, 4096, S), jdraw(theirs, 2, 4096, S)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_pool_sweep_runs_exact_on_the_cpu(capsys):
    out = pool_sweep.main(["--iters", "1", "--size", "64", "--proposals",
                           "24", "--channels", "16"], device="cpu")
    assert _json_line(capsys) == out
    assert out["exact"] and [m["mix"] for m in out["mixes"]] == \
        ["uniform", "voc"]
    for mix in out["mixes"]:
        assert set(mix["ms"]) == {"K1 top-row order", "K1 RoI order",
                                  "K3 banded", "plain"}
        assert set(mix["max_diff"].values()) == {0.0} and mix["calls"] == 3
        assert mix["bound_ms"] > 0 and mix["bound_by"] in ("bytes",
                                                           "operations")
        shares = [mix["shares"][k] for k in ("<=8", "9-24", "25-48", ">48")]
        assert sum(shares) == pytest.approx(1.0)


def test_height_shares_and_short_class():
    """Heights clamped to the map: a RoI reaching past the bottom counts
    only its rows on the map; the short class is band_partition's."""
    boxes = torch.tensor([[[0.0, 0.0, 10.0, 40.0],      # 6 rows
                           [0.0, 0.0, 10.0, 150.0],     # 19 rows
                           [0.0, 480.0, 10.0, 900.0],   # 64 - 60 = 4 rows
                           [0.0, 0.0, 10.0, 500.0]]])   # 63 rows
    shares = pool_sweep.height_shares(boxes, 0.125, 64)
    assert shares["<=8"] == 0.5 and shares["9-24"] == 0.25
    assert shares["25-48"] == 0.0 and shares[">48"] == 0.25
    short = rp.band_partition(boxes, 0.125, 64).short
    assert shares["short"] == short.float().mean().item()


def test_k1_in_roi_order_on_the_cpu_is_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(2, 9, 9, 16, generator=gen).to(torch.bfloat16)
    boxes = torch.from_numpy(pool_sweep.boxes_voc(
        np.random.RandomState(1), 2, 20, 72))
    scale = torch.rand(2, 20, generator=gen)
    np.testing.assert_array_equal(
        pool_sweep.k1_in_roi_order(feats, boxes, scale).float().numpy(),
        rp.roi_pool_plain(feats, boxes, 0.125, 7, scale).float().numpy())
    order = rp.roi_order(boxes)
    assert order.dtype == torch.int32 and order.is_contiguous()
    assert torch.equal(order[1], torch.arange(20, dtype=torch.int32))


def test_roi_pool_bound_moved_unchanged():
    """The values ``chip_smoke.py:roi_pool_bound`` returned before its
    move, for fixed inputs; ``chip_smoke.py`` now calls the package's."""
    boxes = torch.tensor([[[0., 0., 40., 30.], [8., 8., 100., 90.],
                           [-20., 5., 30., 200.]],
                          [[3., 4., 5., 6.], [0., 0., 103., 87.],
                           [50., 60., 20., 10.]]])
    scale = torch.ones(2, 3)
    small = (torch.zeros(2, 11, 13, 32, dtype=torch.bfloat16), boxes, scale,
             torch.zeros(2, 3, 7, 7, 32, dtype=torch.bfloat16))
    assert rp.roi_pool_bound(*small, 0.125) == (1.1116417910447762e-05,
                                                "bytes")
    large = (torch.zeros(2, 88, 88, 2048, dtype=torch.bfloat16), boxes * 7,
             scale, torch.zeros(2, 3, 7, 7, 2048, dtype=torch.bfloat16))
    assert rp.roi_pool_bound(*large, 0.125, 2) == (0.0192964752238806,
                                                   "bytes")
    assert chip_smoke.roi_pool_bound(*small, 0.125) == \
        rp.roi_pool_bound(*small, 0.125)
    assert (rp.PEAK_BYTES_S, rp.PEAK_F32_OPS_S) == (3.35e12, 67e12)


def test_queued_ms_off_the_card_is_the_host_clock():
    calls = []
    ms = benchmark.queued_ms(lambda: calls.append(1), 5, "cpu")
    assert len(calls) == 6 and ms >= 0.0
    assert benchmark.card_tag(torch.device("cpu")) == "[cpu]"


def test_dispatch_probe_runs_on_the_cpu(capsys):
    out = dispatch_probe.main(["--steps", "2", "--launches", "10", *SHAPE,
                               *TOY], device="cpu")
    assert _json_line(capsys) == out
    assert out["trace"] is None and out["host_issue_excess_ms"] is None
    assert out["step"]["event_ms"] is None and out["step"]["host_ms"] > 0
    assert out["launch_us"] > 0 and out["matmul_1024"]["warm_ms"] > 0


def test_scan_k_probe_runs_the_trainer_chunks(capsys):
    out = scan_k_probe.main(["--ks", "1,2", "--steps", "2", *SHAPE, *TOY],
                            device="cpu")
    assert _json_line(capsys) == out
    assert [(r["k"], r["chunks"]) for r in out["rows"]] == [(1, 2), (2, 1)]
    assert all(r["ms_per_step"] > 0 and r["last_chunk_ms"] > 0
               for r in out["rows"])


def test_scan_variants_probe_runs_four_cases(capsys):
    out = scan_variants_probe.main(["--k", "2", *SHAPE, *TOY], device="cpu")
    assert _json_line(capsys) == out
    assert [r["case"] for r in out["rows"]] == list(
        scan_variants_probe.CASES)
    assert all(r["img_per_s"] > 0 for r in out["rows"])


def test_tta_probe_matches_the_jax_draws_and_runs(capsys):
    image, props, obj, labels = tta_probe.probe_image(16, 20)
    rs = np.random.RandomState(0)
    np.testing.assert_array_equal(image, rs.randint(0, 255, (375, 500, 3),
                                                    np.uint8))
    x1 = rs.uniform(0, 400, 16).astype(np.float32)
    np.testing.assert_array_equal(props[:, 0], x1)
    assert labels[3] == 1.0 and labels.sum() == 1.0
    out = tta_probe.main(["--iters", "1", *TOY,
                          "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
                          "TEST.AUG.MIN_SIZES", "(48, 64)",
                          "TEST.AUG.MAX_SIZE", "120",
                          "INPUT.BUCKETS", "(64, 96)"], device="cpu")
    assert _json_line(capsys) == out
    groups = out["groups"]
    assert [g["bucket"] for g in groups] == [64, 96]
    assert sum(g["views"] for g in groups) == 4
    assert all(g["ms_per_view"] == g["score_ms"] / g["views"]
               for g in groups)


def test_cli_throughput_runs_train_net(tmp_path, capsys, catalogs_kept):
    out = cli_throughput.main(
        ["--iters", "4", "--images", "4", "--size", "96", "--proposals",
         "16", "--root", str(tmp_path), *TOY, "SOLVER.STEPS_PER_DISPATCH",
         "2", "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.BUCKETS", "(64, 96)",
         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
         "DATALOADER.NUM_WORKERS", "0"], device="cpu")
    assert _json_line(capsys) == out
    for key in ("metric", "value", "unit", "sec_per_iter_median",
                "sec_per_iter_mean", "sec_per_iter_windows", "mean_img_s",
                "vs_baseline"):
        assert key in out
    # iterations 2-3 are the one chunk past the first: one window
    assert out["steps_per_dispatch"] == 2
    assert len(out["sec_per_iter_windows"]) == 1
    assert out["value"] == 2 / out["sec_per_iter_median"]
    assert len(list((tmp_path / "VOC2007" / "JPEGImages").glob("*.jpg"))) \
        == 4
    assert cli_throughput.DATASET not in DatasetCatalog


@pytest.mark.parametrize("probe", [pool_sweep, dispatch_probe, scan_k_probe,
                                   scan_variants_probe, tta_probe,
                                   cli_throughput])
def test_probes_refuse_missing_cuda(probe, monkeypatch, tmp_path):
    """Each probe runs on the card unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        probe.main(["--root", str(tmp_path)] if probe is cli_throughput
                   else [])
