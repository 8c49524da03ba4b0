"""Export through ``torch.export`` against the JAX package's ``jax.export``,
on the CPU, at toy width: the same weights (``params_from_jax``) and the
same batch through JAX's ``export_inference`` + ``load_exported(...).call``
and the port's, for the flagship (WS-R18 DC5 OICR), RetinaNet and
PanopticFPN, at the slice tolerance (rtol 1e-4, atol 1e-5 x max). The
port's program equals its live model bit for bit; the flagship's graph
holds the K1 op (``drn_wsod::roi_pool_batched``), whose fake
implementation gives the output's shape and dtype; the ``export_model``
CLI writes and checks an artifact."""

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import drn_wsod_torch
from drn_wsod_torch.export import (export_inference, holds_roi_pool,
                                   load_exported)
from drn_wsod_torch.ops import roi_pool as rp
from drn_wsod_torch.tools import export_model
from drn_wsod_tpu.export import export_inference as jax_export
from drn_wsod_tpu.export import load_exported as jax_load
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_panoptic import pan_batch
from test_torch_retinanet import _batch as retina_batch
from test_torch_common import (CONFIGS, FLAGSHIP, TOY, cfg_pair, jax_batch,
                               param_shapes, random_params, unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STD = ("MODEL.PIXEL_STD", [57.4, 57.1, 58.4])
CASES = {
    "flagship": (FLAGSHIP, TOY + STD),
    "retinanet": (str(CONFIGS / "quick_schedules"
                      / "retinanet_R_50_instant_test.yaml"),
                  ("MODEL.FPN.OUT_CHANNELS", 32, "MODEL.RETINANET.NUM_CLASSES",
                   5, "MODEL.DTYPE", "float32") + STD),
    "panoptic": (str(CONFIGS / "Misc" / "panoptic_fpn_R_50_1x.yaml"),
                 ("MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS",
                  64, "MODEL.FPN.OUT_CHANNELS", 32,
                  "MODEL.ROI_HEADS.NUM_CLASSES", 20,
                  "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 4,
                  "MODEL.SEM_SEG_HEAD.NUM_CLASSES", 5,
                  "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16,
                  "MODEL.DTYPE", "float32") + STD),
}


def _batch(C):
    return drn_wsod_torch.synthetic_batch(1, 64, 64, 16, C, seed=5,
                                          device="cpu")


@pytest.fixture(scope="module", params=sorted(CASES))
def exported(request):
    """(name, JAX outputs, port live outputs, port program outputs,
    port program) for one case."""
    yaml, overrides = CASES[request.param]
    jc, pc = cfg_pair(*overrides, yaml=yaml)
    C = (jc.MODEL.RETINANET.NUM_CLASSES if request.param == "retinanet"
         else jc.MODEL.ROI_HEADS.NUM_CLASSES)
    batch = _batch(C)
    jm = jax_build_model(jc)
    init_batch, train = batch, False
    if request.param == "panoptic":
        # the dense models' init needs the GT fields of a training batch
        jm = jm.clone(mask_pooler_resolution=4)
        init_batch, train = pan_batch(4), True
    elif request.param == "retinanet":
        # the candidates are sorted by their best probability: as in
        # test_torch_retinanet.py, 50 a level keeps near-ties out of the cut
        jm = jm.clone(topk_candidates=50)
        batch = retina_batch(3, (96, 80))
        init_batch, train = retina_batch(0), True
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(init_batch),
        train=train)), seed=1)
    variables = {"params": unflatten(flat)}
    want = jax_load(jax_export(jm, variables, jax_batch(batch))).call(
        variables, jax_batch(batch))
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    if request.param == "panoptic":
        pm.mask_pooler_resolution = 4
    if request.param == "retinanet":
        pm.topk_candidates = 50
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    live = pm.inference_scores(batch)
    program = load_exported(export_inference(pm, batch))
    return request.param, want, live, program.call(batch), program


def test_port_program_matches_jax_program(exported):
    _, want, _, got, _ = exported
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max())


def test_port_program_bit_equal_to_live_model(exported):
    _, _, live, got, _ = exported
    for g, w in zip(got, live):
        assert torch.equal(g, w)


def test_graph_holds_k1_where_the_model_pools(exported):
    name, _, _, _, program = exported
    assert holds_roi_pool(program.program) == (1 if name == "flagship" else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_fake_shape_and_dtype(dtype):
    with FakeTensorMode():
        out = torch.ops.drn_wsod.roi_pool_batched(
            torch.empty(2, 11, 13, 32, dtype=dtype), torch.empty(2, 9, 4),
            0.125, 7, torch.empty(2, 9))
    assert out.shape == (2, 9, 7, 7, 32) and out.dtype == dtype


def test_k1_op_is_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(0)
    f = torch.from_numpy(rng.randn(2, 12, 10, 16).astype(np.float32))
    xy = rng.uniform(0, 60, (2, 20, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(1, 40, (2, 20, 2))], -1).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0, 2, (2, 20)).astype(np.float32))
    before = rp.roi_pool_batched.launches
    got = rp.roi_pool_batched(f, boxes, 0.125, 7, scale)
    assert torch.equal(got, rp.roi_pool_plain(f, boxes, 0.125, 7, scale))
    assert rp.roi_pool_batched.launches == before   # no kernel on the CPU


def test_export_model_cli(tmp_path):
    out = tmp_path / "flagship.pt2"
    argv = ["--config-file", FLAGSHIP, "--output", str(out), "--height", "64",
            "--width", "64", "--proposals", "32", "--run-check",
            "MODEL.WEIGHTS", ""]
    for k, v in zip(TOY[0::2], TOY[1::2]):
        argv += [k, repr(v) if not isinstance(v, str) else v]
    data = export_model.main(argv, device="cpu")
    assert out.read_bytes() == data
    program = load_exported(str(out))
    assert holds_roi_pool(program.program) == 1
    batch = drn_wsod_torch.synthetic_batch(1, 64, 64, 32, 20, device="cpu")
    scores, boxes = program.call(batch)
    assert scores.shape == (1, 32, 21) and boxes.shape == (1, 32, 4)
