"""The port's training entry point against the JAX package's, on the CPU
(the counterpart of ``tests/test_e2e_train.py``): ``do_train`` of both
packages' ``tools/train_net.py`` on a VOC-layout directory of JPEG images
and a proposals pickle the test writes, the toy flagship config (R18-WS, DAN
[64, 64], P = 64, 3 OICR branches, float32; then PCL, and CSC with the CSC
step switched off after iteration 1, each 3 steps) with the flagship's crop,
multi-scale resize (two sizes, one bucket) and flip, dropout 0 (the two
frameworks draw different masks), two images a batch, 3 iterations. Both
start from one Detectron2 ``.pkl`` written from numpy weights, each loading
it through its own ``load_reference_weights``.

Tolerance: every named loss at every step within
``tests/test_torch_train_slice.py``'s rtol 1e-4 and atol 1e-5 (float32;
the summation orders differ). The same loader streams give both packages
the same batches, so the losses are compared step for step.

Then ``--resume`` from the checkpoint at step 2 (``MAX_ITER`` 3): it
starts at 2 with the state saved there, bit for bit, and its step's losses
agree with the JAX package's resumed run within the same tolerance. And
``do_test`` without TTA (the test loader, one image a batch) against the
JAX package's from the same weights: each image's detections as in
``tests/test_torch_eval_slice.py`` and AP and CorLoc to 1e-6."""

import importlib.util
import pickle
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch import data as pdata
from drn_wsod_torch.checkpoint import Checkpointer
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_torch.engine import trainer as ptrainer
from drn_wsod_torch.evaluation import voc_eval as pvoc_eval
from drn_wsod_torch.tools import train_net
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import voc as jvoc
from drn_wsod_tpu.evaluation import voc_eval as jvoc_eval
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (FLAGSHIP, TOY, assert_detections_match,
                               cfg_pair, d2_state_dict, jax_batch,
                               param_shapes, random_params, write_voc)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TRAIN, TEST = "torch_train_net_train", "torch_train_net_test"
TRAIN_SIZES = [(40, 56), (64, 48), (33, 70), (50, 50), (61, 45), (47, 66)]
TEST_SIZES = [(44, 60), (58, 41), (50, 50)]
TOPK = 3


def _jax_train_net():
    """The JAX package's ``tools/train_net.py`` as a module. Importing it
    switches JAX's default PRNG; the switch is undone for the tests that
    run after this file in the same process."""
    impl = jax.config.jax_default_prng_impl
    spec = importlib.util.spec_from_file_location(
        "jax_tools_train_net",
        Path(__file__).resolve().parents[1] / "tools" / "train_net.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    jax.config.update("jax_default_prng_impl", impl)
    return module


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_net")
    d, prop_train, _ = write_voc(root / "train", TRAIN_SIZES,
                                 pvoc.VOC_CLASS_NAMES, split="trainval",
                                 seed=21, n_props=90)
    dt, prop_test, _ = write_voc(root / "test", TEST_SIZES,
                                 pvoc.VOC_CLASS_NAMES, split="test", seed=22,
                                 n_props=90)
    for reg in (pvoc.register_pascal_voc, jvoc.register_pascal_voc):
        reg(TRAIN, d, "trainval", 2007)
        reg(TEST, dt, "test", 2007)
    opts = (*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
            "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0,
            "INPUT.MIN_SIZE_TRAIN", (48, 64), "INPUT.MAX_SIZE_TRAIN", 90,
            "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 90,
            "INPUT.BUCKETS", [96], "SOLVER.IMS_PER_BATCH", 2,
            "SOLVER.MAX_ITER", 3, "SOLVER.CHECKPOINT_PERIOD", 2,
            "SOLVER.STEPS_PER_DISPATCH", 1, "SEED", 0,
            "TEST.AUG.ENABLED", False, "TEST.EVAL_PERIOD", 0,
            "TEST.EVAL_TRAIN", False, "TEST.DETECTIONS_PER_IMAGE", TOPK,
            "DATASETS.TRAIN", (TRAIN,), "DATASETS.TEST", (TEST,),
            "DATASETS.PROPOSAL_FILES_TRAIN", (prop_train,),
            "DATASETS.PROPOSAL_FILES_TEST", (prop_test,),
            "DATALOADER.NUM_WORKERS", 0, "PARALLEL.MESH_SHAPE", [1])
    jc, pc = cfg_pair(*opts)
    # one Detectron2 checkpoint from numpy weights under the flax names
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    init = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, 20, seed=3,
                                          device="cpu")
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(init), train=False)),
        seed=5)
    weights = root / "model_init.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": d2_state_dict(
            drn_wsod_torch.params_from_jax(flat))}, f)
    for cfg in (jc, pc):
        cfg.MODEL.WEIGHTS = str(weights)
    yield root, jc, pc, _jax_train_net()
    for pkg in (pdata, jdata):
        pkg.DatasetCatalog.remove(TRAIN)
        pkg.DatasetCatalog.remove(TEST)


def _with(cfg, **kv):
    cfg = cfg.clone()
    for k, v in kv.items():
        node = cfg
        *path, leaf = k.split("__")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, v)
    cfg.freeze()
    return cfg


def _jax_train(jtn, jc, monkeypatch, resume=False, steps=None):
    """The JAX package's do_train; returns (state, per-step losses). With
    a list ``steps``, each step's kind ("plain" or "csc") is appended."""
    losses = []

    def recording(make, kind):
        def wrapped(*a, **k):
            fn = make(*a, **k)

            def step(state, batch, rng):
                state, m = fn(state, batch, rng)
                losses.append({n: float(v)
                               for n, v in jax.device_get(m).items()})
                if steps is not None:
                    steps.append(kind)
                return state, m
            return step
        return wrapped

    for name, kind in (("make_sharded_train_step", "plain"),
                       ("make_sharded_csc_train_step", "csc")):
        monkeypatch.setattr(jtn, name, recording(getattr(jtn, name), kind))
    state = jtn.do_train(jc, jax_build_model(jc), resume=resume)
    return state, losses


def _port_train(pc, monkeypatch, resume=False, steps=None):
    """The port's do_train; returns (trainer, per-step losses, state right
    after resume_or_load). With a list ``steps``, each step's kind is
    appended."""
    losses, restored = [], {}
    resume_or_load = Checkpointer.resume_or_load

    def recording(make, kind):
        def wrapped(*a, **k):
            fn = make(*a, **k)

            def step(state, batch, seed):
                state, m = fn(state, batch, seed)
                losses.append({n: float(v) for n, v in m.items()})
                if steps is not None:
                    steps.append(kind)
                return state, m
            return step
        return wrapped

    def snapshot(self, state, *a, **k):
        state, start = resume_or_load(self, state, *a, **k)
        restored.update({f"model.{n}": t.clone()
                         for n, t in state.model.state_dict().items()})
        restored.update({f"trace.{n}": t.clone()
                         for n, t in state.opt_state["trace"].items()})
        restored["start"], restored["step"] = start, state.step
        return state, start

    for name, kind in (("make_train_step", "plain"),
                       ("make_csc_train_step", "csc")):
        monkeypatch.setattr(ptrainer, name,
                            recording(getattr(ptrainer, name), kind))
    monkeypatch.setattr(Checkpointer, "resume_or_load", snapshot)
    model = drn_wsod_torch.build_model(pc, device="cpu")
    trainer = train_net.do_train(pc, model, resume=resume, device="cpu")
    return trainer, losses, restored


def _assert_losses_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_do_train_and_resume_match_jax(setup, monkeypatch):
    root, jc, pc, jtn = setup
    out = root / "out"
    jc3 = _with(jc, OUTPUT_DIR=str(out / "jax"))
    pc3 = _with(pc, OUTPUT_DIR=str(out / "port"))
    _, want = _jax_train(jtn, jc3, monkeypatch)
    trainer, got, restored = _port_train(pc3, monkeypatch)
    assert restored["start"] == 0 and trainer.state.step == 3
    _assert_losses_close(got, want)
    assert len(got) == 3 and {"loss_cls", "loss_cls_r2",
                              "total_loss"} <= got[0].keys()
    ck = Checkpointer(str(out / "port" / "checkpoints"))
    assert ck.all_steps() == [2, 3]
    lines = (out / "port" / "metrics.json").read_text().splitlines()
    assert lines and all('"total_loss"' in line for line in lines)

    # resume from the checkpoint at step 2, to 3
    shutil.rmtree(out / "jax" / "checkpoints" / "3")     # orbax: a folder
    Path(ck.path(3)).unlink()
    saved = torch.load(ck.path(2), weights_only=True)
    assert Checkpointer(str(out / "port" / "checkpoints")).all_steps() == [2]
    _, want_r = _jax_train(jtn, jc3, monkeypatch, resume=True)
    trainer, got_r, restored = _port_train(pc3, monkeypatch, resume=True)
    assert restored["start"] == 2 == restored["step"]
    for n, t in saved["model"].items():
        assert torch.equal(restored[f"model.{n}"], t), n
    for n, t in saved["opt_state"]["trace"].items():
        assert torch.equal(restored[f"trace.{n}"], t), n
    assert trainer.state.step == 3 and len(got_r) == 1
    _assert_losses_close(got_r, want_r)


def test_do_test_without_tta_matches_jax(setup, monkeypatch):
    """The test loader's arm of ``do_test`` (both packages), from the same
    weights: each image's detections within tolerance, AP and CorLoc to
    1e-6 where no two detections of a class are within tolerance."""
    _, jc, pc, jtn = setup
    jm = jax_build_model(jc)
    from drn_wsod_tpu.checkpoint import torch_import as jimport
    from drn_wsod_tpu.engine.defaults import _init_variables

    variables = jimport.load_reference_weights(jc.MODEL.WEIGHTS,
                                               _init_variables(jm, jc))
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    drn_wsod_torch.load_reference_weights(pc.MODEL.WEIGHTS, pm)

    dets = {}
    for name, cls in (("p", pvoc_eval.PascalVOCDetectionEvaluator),
                      ("j", jvoc_eval.PascalVOCDetectionEvaluator)):
        process = cls.process_single

        def recording(self, image_id, boxes, scores, classes, valid,
                      _n=name, _p=process):
            dets.setdefault(_n, {})[image_id] = {
                "boxes": np.asarray(boxes), "scores": np.asarray(scores),
                "classes": np.asarray(classes), "valid": np.asarray(valid)}
            return _p(self, image_id, boxes, scores, classes, valid)

        monkeypatch.setattr(cls, "process_single", recording)
    got = train_net.do_test(pc, pm, device="cpu")[TEST]
    want = jtn.do_test(jc, jm, variables)[TEST]
    assert dets["p"].keys() == dets["j"].keys() and len(dets["p"]) == 3
    for image_id, d in dets["p"].items():
        assert_detections_match(d, dets["j"][image_id], RTOL, ATOL, TOPK)
    for task in ("bbox", "bbox CorLoc"):
        for k, v in want[task].items():
            if isinstance(v, float):
                assert abs(got[task][k] - v) <= 1e-6, (task, k)


@pytest.fixture
def root_logging(monkeypatch):
    """``main``'s set-up replaces the root logger's handlers: restore them
    after the test."""
    import logging

    root = logging.getLogger()
    monkeypatch.setattr(root, "handlers", root.handlers[:])
    monkeypatch.setattr(root, "level", root.level)


def test_main_trains_then_evaluates(setup, tmp_path, root_logging):
    """``main`` without --eval-only trains to MAX_ITER and evaluates;
    ``--resume`` with nothing left to train only evaluates; ``--eval-only``
    loads the checkpoint with --resume."""
    root, _, pc, _ = setup
    opts = []
    for k, v in zip(TOY[0::2], TOY[1::2]):
        opts += [k, v if isinstance(v, str) else repr(v)]
    for key in ("MODEL.PIXEL_STD", "INPUT.MIN_SIZE_TRAIN",
                "INPUT.MAX_SIZE_TRAIN", "INPUT.MIN_SIZE_TEST",
                "INPUT.MAX_SIZE_TEST", "INPUT.BUCKETS",
                "SOLVER.IMS_PER_BATCH", "DATASETS.TRAIN", "DATASETS.TEST",
                "DATASETS.PROPOSAL_FILES_TRAIN",
                "DATASETS.PROPOSAL_FILES_TEST", "MODEL.WEIGHTS"):
        v = pc.get_by_path(key)
        opts += [key, v if isinstance(v, str) else repr(v)]
    opts += ["MODEL.ROI_BOX_HEAD.DROPOUT", "0.0", "SOLVER.MAX_ITER", "2",
             "SOLVER.CHECKPOINT_PERIOD", "8", "TEST.AUG.ENABLED", "False",
             "TEST.EVAL_PERIOD", "0", "TEST.EVAL_TRAIN", "False",
             "OUTPUT_DIR", str(tmp_path), "DATALOADER.NUM_WORKERS", "2"]
    parse = train_net.argument_parser().parse_args
    first = train_net.main(parse(["--config-file", FLAGSHIP, *opts]),
                           device="cpu")
    assert list(first) == [TEST]
    ck = Checkpointer(str(tmp_path / "checkpoints"))
    assert ck.all_steps() == [2]
    assert (tmp_path / "config.yaml").exists()
    assert (tmp_path / "metrics.json").exists()
    again = train_net.main(parse(["--config-file", FLAGSHIP, "--resume",
                                  *opts]), device="cpu")
    assert again == first and ck.all_steps() == [2]
    evaluated = train_net.main(parse(["--config-file", FLAGSHIP,
                                      "--eval-only", "--resume", *opts]),
                               device="cpu")
    assert evaluated == first


def _ulp_sensitive(prev, proposals, mask, labels, trials=20):
    """Whether nudging every score of a PCL mining input by one ulp up or
    down (seeded at random) changes a center, the valid mask or a center's
    score beyond float noise (a center can stay while its graph neighbours
    change): there, the two frameworks' float32 sums upstream may part the
    clusters."""
    from drn_wsod_torch.ops.pcl import mine_pcl_clusters

    base = mine_pcl_clusters(prev, proposals, mask, labels)
    for t in range(trials):
        up = torch.rand(prev.shape,
                        generator=torch.Generator().manual_seed(t)) < 0.5
        nudged = torch.where(up, torch.nextafter(prev, prev + 1),
                             torch.nextafter(prev, prev - 1))
        other = mine_pcl_clusters(nudged, proposals, mask, labels)
        if not (torch.equal(base.centers, other.centers)
                and torch.equal(base.center_valid, other.center_valid)
                and torch.allclose(base.center_scores, other.center_scores,
                                   rtol=1e-5, atol=0.0)):
            return True
    return False


@pytest.mark.parametrize("head,overrides", [
    ("PCLROIHeads", {}),
    # the CSC step at iterations 0 and 1, the plain step at 2
    ("CSCROIHeads", {"WSL__CSC_MAX_ITER": 1})])
def test_do_train_other_heads_match_jax(setup, monkeypatch, head, overrides):
    """3 steps of ``do_train`` with each head. CSC: every loss at every
    step, and the step switch at the JAX package's iteration.

    PCL: the clusters are a discontinuous function of the previous
    branch's scores, and the two frameworks' float32 softmax and sums
    differ in the last bits. Each of the port's mining inputs is probed:
    where nudging its scores by one ulp changes the clusters, JAX's equally
    valid inputs may give other clusters, and the trajectories part there.
    Every loss is compared up to the first step with such an input; at
    that step, every loss but those branches' (later steps start from
    parameters that moved differently). ROADMAP.md section 3 logs the case
    this data meets."""
    from drn_wsod_torch.ops import pcl as pcl_lib

    root, jc, pc, jtn = setup
    out = root / f"out_{head}"
    kv = dict(MODEL__ROI_HEADS__NAME=head, SOLVER__CHECKPOINT_PERIOD=8,
              **overrides)
    jc3 = _with(jc, OUTPUT_DIR=str(out / "jax"), **kv)
    pc3 = _with(pc, OUTPUT_DIR=str(out / "port"), **kv)
    mined = []
    branch_loss = pcl_lib.pcl_branch_loss

    def recording(cls_logits, prev, proposals, mask, labels, **k):
        mined.append((prev.clone(), proposals, mask, labels))
        return branch_loss(cls_logits, prev, proposals, mask, labels, **k)

    monkeypatch.setattr(pcl_lib, "pcl_branch_loss", recording)
    jax_steps, port_steps = [], []
    _, want = _jax_train(jtn, jc3, monkeypatch, steps=jax_steps)
    trainer, got, _ = _port_train(pc3, monkeypatch, steps=port_steps)
    assert trainer.state.step == 3
    assert port_steps == jax_steps == (
        ["csc", "csc", "plain"] if head == "CSCROIHeads" else ["plain"] * 3)
    names = ({"loss_cls_pos", "loss_cls_neg"} if head == "CSCROIHeads"
             else {"loss_cls", "loss_cls_r0", "loss_cls_r1", "loss_cls_r2"})
    assert names <= got[0].keys()
    if head == "CSCROIHeads":
        _assert_losses_close(got, want)
        return
    assert len(mined) == 3 * 3                  # 3 branches a step
    parted = [_ulp_sensitive(*m) for m in mined]
    first = next((i // 3 for i, p in enumerate(parted) if p), 3)
    assert first >= 1                           # step 0 compared in full
    _assert_losses_close(got[:first], want[:first])
    if first < 3:
        skip = {"total_loss"} | {f"loss_cls_r{k}" for k in range(3)
                                 if parted[first * 3 + k]}
        _assert_losses_close(
            [{k: v for k, v in got[first].items() if k not in skip}],
            [{k: v for k, v in want[first].items() if k not in skip}])


def test_do_train_refuses_what_is_not_ported(setup):
    """Nothing is refused any more: pseudo-GT visualisation is ported
    (``VIS_PERIOD``, or ``WSL.VIS_TEST`` at the checkpoint period, for the
    OICR, PCL and WSDDN heads; ``tests/test_torch_tools_cli.py`` trains
    with it). Its period joins the periods that bound the steps a dispatch
    for every head, as in the JAX trainer (``tools/train_net.py``)."""
    _, _, pc, _ = setup
    assert train_net.vis_period(_with(pc, VIS_PERIOD=10)) == 10
    assert train_net.vis_period(_with(pc, WSL__VIS_TEST=True,
                                      SOLVER__CHECKPOINT_PERIOD=7)) == 7
    assert train_net.vis_period(_with(
        pc, VIS_PERIOD=10, MODEL__ROI_HEADS__NAME="CSCROIHeads")) == 10
    assert "CSCROIHeads" not in train_net.PGT_HEADS
    assert train_net.steps_per_dispatch(_with(
        pc, SOLVER__STEPS_PER_DISPATCH=20, SOLVER__CHECKPOINT_PERIOD=5000,
        VIS_PERIOD=6, MODEL__ROI_HEADS__NAME="StandardROIHeads")) == 2
    assert train_net.steps_per_dispatch(_with(
        pc, SOLVER__STEPS_PER_DISPATCH=20, SOLVER__CHECKPOINT_PERIOD=5000,
        VIS_PERIOD=6)) == 2
    assert train_net.steps_per_dispatch(_with(
        pc, SOLVER__STEPS_PER_DISPATCH=20, SOLVER__CHECKPOINT_PERIOD=8)) == 4
    assert train_net.steps_per_dispatch(_with(
        pc, SOLVER__STEPS_PER_DISPATCH=20, SOLVER__CHECKPOINT_PERIOD=5000,
        TEST__EVAL_PERIOD=10000)) == 20
