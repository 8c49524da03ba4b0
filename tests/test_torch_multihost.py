"""The port's process-group helpers, per-process loaders, the cross-process
gather and ``train_net.main`` over several processes, on the CPU (gloo
ranks of ``tests/torch_dist_worker.py``), against the JAX package where it
has the same behaviour:

* ``parallel/multihost.py`` without a group is the JAX module at one
  process: rank 0 of 1, the main process, ``[obj]``, ``reduce_dict`` the
  identity; ``init_process_group`` does nothing below ``WORLD_SIZE`` 2;
* ``TrainLoader(process_index=r, process_count=2)`` yields bit for bit the
  JAX loader's batches for r = 0, 1 (ids, buckets, images, boxes,
  proposals), and the two ranks' batches are the one-process planned
  global batch's ``b[0::2] + b[1::2]``; ``process_count=1`` is the
  single-process loader, unchanged; ``plan_bucket`` equals the decoded
  bucket (the invariants of ``tests/test_multihost.py``);
* ``EvalLoader(process_index=r, process_count=2)`` equals the JAX loader's
  shard;
* ``gather_and_evaluate`` over a real two-rank group equals one evaluator
  over all images on rank 0 and returns {} on rank 1;
* ``train_net.main`` as two gloo ranks under torchrun's environment
  variables: rank 0 alone writes ``metrics.json``, ``config.yaml`` and the
  checkpoints, rank 1 logs to ``log.txt.rank1``; rank 0's VOC AP and
  CorLoc equal a one-process ``--eval-only --resume`` on the checkpoint
  they wrote; rank 1 returns {} for each dataset.
"""

import json
import os

import numpy as np
import pytest
import torch

from drn_wsod_torch import data as pdata
from drn_wsod_torch.checkpoint import Checkpointer
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_torch.evaluation import PascalVOCDetectionEvaluator
from drn_wsod_torch.parallel import multihost as pmh
from drn_wsod_torch.tools import train_net
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import voc as jvoc
from drn_wsod_tpu.parallel import multihost as jmh
from test_torch_common import FLAGSHIP, TOY, cfg_pair, write_voc
from test_torch_train_data import OPTS, _assert_batches_equal, _packed
from torch_dist_worker import launch

torch.set_num_threads(1)

NAME = "torch_multihost_test"
SIZES = [(40, 56), (64, 48), (33, 70), (50, 50), (61, 45), (47, 66),
         (70, 33), (45, 61)]
GLOBAL_BS = 4


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    d, prop_file, images = write_voc(root, SIZES, pvoc.VOC_CLASS_NAMES,
                                     split="trainval", seed=9, n_props=60)
    pvoc.register_pascal_voc(NAME, d, "trainval", 2007)
    jvoc.register_pascal_voc(NAME, d, "trainval", 2007)
    records = pdata.get_detection_dataset_dicts([NAME], [prop_file],
                                                filter_empty=False)
    yield d, prop_file, images, _packed(records, images)
    pdata.DatasetCatalog.remove(NAME)
    jdata.DatasetCatalog.remove(NAME)


def _mappers(train=True):
    jc, pc = cfg_pair(*OPTS, "SOLVER.IMS_PER_BATCH", GLOBAL_BS)
    return (pdata.DatasetMapper(pc, is_train=train),
            jdata.DatasetMapper(jc, is_train=train))


def test_multihost_helpers_without_a_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not pmh.is_initialized()
    assert (pmh.get_world_size(), pmh.get_rank(), pmh.is_main_process()) \
        == (jmh.get_world_size(), jmh.get_rank(), jmh.is_main_process()) \
        == (1, 0, True)
    obj = {"a": [1, 2]}
    assert pmh.all_gather_object(obj) == jmh.all_gather_object(obj) == [obj]
    m = {"loss": 0.5, "time": 2.0}
    assert pmh.reduce_dict(m) == jmh.reduce_dict(m) == m
    assert pmh.reduce_dict(m, average=False) == m
    pmh.synchronize()
    assert pmh.init_process_group() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert pmh.init_process_group() is False and not pmh.is_initialized()


@pytest.mark.parametrize("rank", [0, 1])
def test_train_loader_shim_equals_jax(voc, rank):
    records = voc[3]
    pm, jm = _mappers()
    got = iter(pdata.TrainLoader(records, pm, GLOBAL_BS, seed=3, prefetch=0,
                                 process_index=rank, process_count=2))
    want = iter(jdata.TrainLoader(records, jm, GLOBAL_BS, seed=3, prefetch=0,
                                  process_index=rank, process_count=2))
    shapes = set()
    for _ in range(6):
        g, w = next(got), next(want)
        assert g.image.shape[0] == GLOBAL_BS // 2
        _assert_batches_equal(g, w)
        shapes.add(tuple(g.image.shape))
    assert len(shapes) > 1


@pytest.mark.parametrize("rank", [0, 1])
def test_train_loader_workers_decode_the_same_slices(voc, rank):
    """With ``num_workers`` threads the rank's slices are decoded on the
    pool and come out bit for bit as decoded on the consumer thread."""
    records = voc[3]
    pm, _ = _mappers()
    got, want = (iter(pdata.TrainLoader(records, pm, GLOBAL_BS, seed=3,
                                        prefetch=0, num_workers=w,
                                        process_index=rank, process_count=2))
                 for w in (3, 0))
    for _ in range(6):
        g, w = next(got).tensors(), next(want).tensors()
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k


def test_ranks_slice_the_planned_global_batch(voc):
    """Rank r decodes ``b[r::2]`` of each global batch the shared stream
    plans: together the ranks hold the one-process batch of the planned
    bucket (the single-process loader groups by the decoded bucket, which
    ``plan_bucket`` predicts)."""
    records = voc[3]
    pm, _ = _mappers()
    ranks = [iter(pdata.TrainLoader(records, pm, GLOBAL_BS, seed=5,
                                    prefetch=0, process_index=r,
                                    process_count=2)) for r in range(2)]
    whole = iter(pdata.TrainLoader(records, pm, GLOBAL_BS, seed=5,
                                   prefetch=0, process_count=1))
    for _ in range(4):
        r0, r1 = next(ranks[0]), next(ranks[1])
        w = next(whole)
        ids = w.image_id.tolist()
        assert r0.image_id.tolist() + r1.image_id.tolist() == \
            ids[0::2] + ids[1::2]
        assert r0.image.shape == r1.image.shape == \
            (2,) + tuple(w.image.shape[1:])


def test_plan_bucket_equals_decoded_bucket(voc):
    records = voc[3]
    pm, jm = _mappers()
    for seed in range(4):
        for i, r in enumerate(records):
            rs = np.random.RandomState(seed * 13 + i)
            plan = pm.plan_bucket(r, np.random.RandomState(seed * 13 + i))
            assert plan == pm(r, rs, dataset_index=i)["_bucket"] == \
                jm.plan_bucket(r, np.random.RandomState(seed * 13 + i))


def test_single_process_loader_unchanged(voc):
    """``process_count=1`` (and the default, without a group) is the
    single-process loader, bit-equal to the JAX one."""
    records = voc[3]
    pm, jm = _mappers()
    default = iter(pdata.TrainLoader(records, pm, 2, seed=1, prefetch=0))
    one = iter(pdata.TrainLoader(records, pm, 2, seed=1, prefetch=0,
                                 process_index=0, process_count=1))
    want = iter(jdata.TrainLoader(records, jm, 2, seed=1, prefetch=0,
                                  process_index=0, process_count=1))
    for _ in range(5):
        d, g, w = next(default), next(one), next(want)
        _assert_batches_equal(g, w)
        _assert_batches_equal(d, w)


@pytest.mark.parametrize("rank", [0, 1])
def test_eval_loader_shard_equals_jax(voc, rank):
    records = voc[3]
    pm, jm = _mappers(train=False)
    got = pdata.EvalLoader(records, pm, batch_size=2, prefetch=0,
                           process_index=rank, process_count=2)
    want = jdata.EvalLoader(records, jm, batch_size=2, prefetch=0,
                            process_index=rank, process_count=2)
    assert got._records == want._records == records[rank::2]
    assert got.all_records is records
    for (g, gn), (w, wn) in zip(got, want):
        assert gn == wn
        w = w.replace(image=np.asarray(w.image).astype(np.uint8))
        _assert_batches_equal(g, w)


# ----------------------------------------------------- two-rank groups
def _detections(records, seed=0):
    rs = np.random.RandomState(seed)
    out = {}
    for r in records:
        n = 5
        xy = rs.uniform(0, 30, (n, 2))
        boxes = np.concatenate([xy, xy + rs.uniform(5, 30, (n, 2))], 1)
        out[str(r["image_id"])] = (boxes.astype(np.float32),
                                   rs.uniform(0, 1, n).astype(np.float32),
                                   rs.randint(0, 20, n).astype(np.int64),
                                   np.ones(n, bool))
    return out


def test_gather_and_evaluate_over_two_ranks(voc, tmp_path):
    records = voc[3]
    gt = {str(r["image_id"]): r.get("annotations", []) for r in records}
    dets = _detections(records)
    want_ev = PascalVOCDetectionEvaluator(pvoc.VOC_CLASS_NAMES, gt)
    want_ev.reset()
    for image_id, d in dets.items():
        want_ev.process_single(image_id, *d)
    want = want_ev.evaluate()
    results = launch({"cases": {"gather": {
        "kind": "gather", "classes": pvoc.VOC_CLASS_NAMES, "gt": gt,
        "detections": dets}}}, 2, tmp_path, timeout=120)
    assert results[0]["gather"] == want
    assert results[1]["gather"] == {}


@pytest.fixture
def root_logging(monkeypatch):
    """``main``'s set-up replaces the root logger's handlers: restore
    them after the test."""
    import logging

    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", root.handlers[:])
    monkeypatch.setattr(root, "level", root.level)


def test_train_net_main_over_two_ranks(voc, tmp_path, root_logging):
    d, prop_file, _, _ = voc
    test_dir, test_props, _ = write_voc(tmp_path / "test", SIZES[:4],
                                        pvoc.VOC_CLASS_NAMES, split="test",
                                        seed=10, n_props=60)
    test_name = NAME + "_eval"
    pvoc.register_pascal_voc(test_name, test_dir, "test", 2007)
    out = tmp_path / "out"
    opts = []
    for k, v in zip(TOY[0::2], TOY[1::2]):
        opts += [k, v if isinstance(v, str) else repr(v)]
    opts += ["MODEL.PIXEL_STD", "[57.4, 57.1, 58.4]",
             "INPUT.MIN_SIZE_TRAIN", "(48, 64)", "INPUT.MAX_SIZE_TRAIN", "90",
             "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "90",
             "INPUT.BUCKETS", "[96]", "SOLVER.IMS_PER_BATCH", "2",
             "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
             "TEST.AUG.ENABLED", "False", "TEST.EVAL_PERIOD", "0",
             "TEST.EVAL_TRAIN", "False", "TEST.DETECTIONS_PER_IMAGE", "3",
             "DATASETS.TRAIN", f"('{NAME}',)",
             "DATASETS.TEST", f"('{test_name}',)",
             "DATASETS.PROPOSAL_FILES_TRAIN", f"('{prop_file}',)",
             "DATASETS.PROPOSAL_FILES_TEST", f"('{test_props}',)",
             "DATALOADER.NUM_WORKERS", "0", "MODEL.WEIGHTS", "''",
             "OUTPUT_DIR", str(out)]
    argv = ["--config-file", FLAGSHIP, *opts]
    try:
        results = launch({"cases": {"main": {
            "kind": "main", "argv": argv,
            "register": [(NAME, str(d), "trainval"),
                         (test_name, str(test_dir), "test")]}}},
            2, tmp_path / "ranks", timeout=240)
        ck = Checkpointer(str(out / "checkpoints"))
        assert ck.all_steps() == [2]
        assert (out / "config.yaml").exists()
        assert (out / "log.txt").exists() and (out / "log.txt.rank1").exists()
        # one writer: the last step's line and the after-train line (two
        # writers would append each twice)
        lines = (out / "metrics.json").read_text().splitlines()
        assert [json.loads(ln)["iteration"] for ln in lines] == [1, 2]
        assert sorted(os.listdir(out / "checkpoints")) == ["model_0000002.pth"]
        r0, r1 = results[0]["main"], results[1]["main"]
        assert (r0["rank"], r1["rank"]) == (0, 1)
        assert r1["results"] == {test_name: {}}
        parse = train_net.argument_parser().parse_args
        one = train_net.main(parse(argv[:2] + ["--eval-only", "--resume"]
                                   + argv[2:]), device="cpu")
        assert r0["results"] == one
        assert one[test_name]["bbox"]["AP50"] >= 0
    finally:
        pdata.DatasetCatalog.remove(test_name)
