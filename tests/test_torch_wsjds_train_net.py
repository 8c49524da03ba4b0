"""``do_train`` on ``ws_jds_WSR_18_DC5_1x.yaml`` (WSJDS: the CSC head with
the seg branch) against the JAX package's
``tools/train_net.py``, on the CPU, with the helpers of
``tests/test_torch_train_net.py``: a VOC-layout directory of JPEG images
and a proposals pickle the test writes, narrow heads (DAN [64, 64]),
float32, dropout 0, two images a batch, 3 iterations with
``WSL.CSC_MAX_ITER 1``: the CSC step at iterations 0 and 1, the plain step
at 2, each package switching at its own iteration. Both start from one
Detectron2 ``.pkl`` (the seg head under ``seg_head.``) written from numpy
weights. ``SEM_SEG_HEAD.CONSTRAINT`` is off here: the CRF in both steps
takes JAX's compile past this file's minute, and
``tests/test_torch_wsjds_step.py`` compares ``loss_constraint`` step by
step.

Tolerance: every named loss (``loss_seg`` included) at every step within
rtol 1e-4 and atol 1e-5."""

import pickle

import jax
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch import data as pdata
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import voc as jvoc
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (CONFIGS, cfg_pair, d2_state_dict, jax_batch,
                               param_shapes, random_params, write_voc)
from test_torch_train_net import (_assert_losses_close, _jax_train,
                                  _jax_train_net, _port_train)

torch.set_num_threads(1)

TRAIN, TEST = "torch_wsjds_train", "torch_wsjds_test"
YAML = CONFIGS / "PascalVOC-Detection" / "ws_jds_WSR_18_DC5_1x.yaml"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("wsjds_train_net")
    d, prop_train, _ = write_voc(root / "train",
                                 [(40, 56), (64, 48), (50, 50), (61, 45)],
                                 pvoc.VOC_CLASS_NAMES, split="trainval",
                                 seed=31, n_props=60)
    dt, prop_test, _ = write_voc(root / "test", [(44, 60)],
                                 pvoc.VOC_CLASS_NAMES, split="test", seed=32,
                                 n_props=60)
    for reg in (pvoc.register_pascal_voc, jvoc.register_pascal_voc):
        reg(TRAIN, d, "trainval", 2007)
        reg(TEST, dt, "test", 2007)
    jc, pc = cfg_pair(
        "MODEL.ROI_BOX_HEAD.DAN_DIM", [64, 64], "MODEL.DTYPE", "float32",
        "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
        "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0,
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
        "INPUT.MIN_SIZE_TRAIN", (48, 64), "INPUT.MAX_SIZE_TRAIN", 90,
        "INPUT.BUCKETS", [96], "SOLVER.IMS_PER_BATCH", 2,
        "SOLVER.MAX_ITER", 3, "SOLVER.CHECKPOINT_PERIOD", 8,
        "SOLVER.STEPS_PER_DISPATCH", 1, "SEED", 0, "WSL.CSC_MAX_ITER", 1,
        "TEST.AUG.ENABLED", False, "TEST.EVAL_PERIOD", 0,
        "DATASETS.TRAIN", (TRAIN,), "DATASETS.TEST", (TEST,),
        "DATASETS.PROPOSAL_FILES_TRAIN", (prop_train,),
        "DATASETS.PROPOSAL_FILES_TEST", (prop_test,),
        "DATALOADER.NUM_WORKERS", 0, "PARALLEL.MESH_SHAPE", [1],
        "MODEL.SEM_SEG_HEAD.CONSTRAINT", False, yaml=str(YAML))
    assert jc.MODEL.ROI_HEADS.NAME == "WSJDSROIHeads"
    assert not jc.MODEL.SEM_SEG_HEAD.CONSTRAINT
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    init = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, 20, seed=3,
                                          device="cpu")
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(init), train=True)),
        seed=5)
    assert any(k.startswith("seg_head.") for k in flat)
    weights = root / "model_init.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": d2_state_dict(
            drn_wsod_torch.params_from_jax(flat))}, f)
    for cfg in (jc, pc):
        cfg.MODEL.WEIGHTS = str(weights)
        cfg.OUTPUT_DIR = str(root / ("jax" if cfg is jc else "port"))
        cfg.freeze()
    yield jc, pc, _jax_train_net()
    for pkg in (pdata, jdata):
        pkg.DatasetCatalog.remove(TRAIN)
        pkg.DatasetCatalog.remove(TEST)


def test_do_train_across_the_csc_switch_matches_jax(setup, monkeypatch):
    jc, pc, jtn = setup
    jax_steps, port_steps = [], []
    _, want = _jax_train(jtn, jc, monkeypatch, steps=jax_steps)
    trainer, got, _ = _port_train(pc, monkeypatch, steps=port_steps)
    assert trainer.state.step == 3
    assert port_steps == jax_steps == ["csc", "csc", "plain"]
    csc = {"loss_cls_pos", "loss_cls_neg", "loss_seg"}
    assert csc <= got[0].keys() and csc <= got[1].keys()
    # the plain step: the WSDDN loss, no CPG maps
    assert set(got[2]) == {"loss_cls", "total_loss"}
    _assert_losses_close(got, want)
