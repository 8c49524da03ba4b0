"""The port's multi-device training (``drn_wsod_torch/parallel``) on the
CPU, over gloo process groups of 2 and 4 ranks
(``tests/torch_dist_worker.py``):

* against the JAX package: two ranks on ``("data",) = (2,)`` against
  ``make_sharded_train_step`` on a 2-device mesh of the 8 virtual CPU
  devices, and four ranks on ``("data", "model") = (2, 2)`` (the DAN
  split) against JAX's ``(2, 2)`` mesh; the toy flagship (R18, DAN [64,
  64], float32), dropout 0 (the two frameworks draw different masks), 3
  steps, global batch 4; losses within rtol 2e-5 (as
  ``tests/test_parallel.py``), atol 1e-7, updated parameters within rtol
  2e-5, atol 1e-6;
* four ranks on ``("data",) = (4,)``, one image a rank, against JAX's
  4-device mesh and, for WSDDN and OICR at dropout 0.5, against the port's
  one-process step;
* against the port's own one-process step on the rank-major global batch
  (rank 0's rows first), dropout 0.5 wherever the head has dropout (every
  rank draws the global batch's masks and sampler keys): WSDDN, OICR, PCL,
  the CSC step, Fast R-CNN, Cascade R-CNN, Mask R-CNN, Keypoint R-CNN,
  RetinaNet, a one-level RPN (``rpn_batch_losses``), the semantic FPN, and
  OICR under the split ``(1, 2)``, also with the global-norm gradient clip
  on; the K-step chunked step; losses within
  rtol 2e-5, atol 1e-7, parameters within rtol 2e-5, atol 1e-6 (float
  summation order only: one weight in millions moves by 1.2e-7); Keypoint
  R-CNN for one step: the biases of its eight 512-channel convs take
  gradients that cancel to a small fraction of their terms, and from the
  second step on float order moves them by up to 5e-6 from run to run
  while the loss agrees within 2e-5 (step 1 agrees within 1e-9); and
  every rank's full parameters and buffers bit-equal after every step;
* the checkpoint written by ``(1, 2)`` loads at world 1 to the same
  tensors, and a world-1 checkpoint loads into ``(1, 2)``;
* the mesh's unit rules against the JAX package's (``create_mesh``'s -1,
  ``dan_tp_spec``), ``shard_batch`` / ``rank_major``, and one process
  (no group) unchanged.
"""

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch import Checkpointer
from drn_wsod_torch.models.heads.box_head import DiscriminativeAdaptionNeck
from drn_wsod_torch.parallel import context
from drn_wsod_torch.parallel import mesh as pmesh
from drn_wsod_torch.parallel import train_parallel as ptp
from drn_wsod_tpu.engine import create_train_state as jax_create_state
from drn_wsod_tpu.parallel import create_mesh as jax_create_mesh
from drn_wsod_tpu.parallel import make_sharded_train_step as jax_sharded
from drn_wsod_tpu.parallel import shard_batch as jax_shard_batch
from drn_wsod_tpu.parallel import state_shardings as jax_state_shardings
from drn_wsod_tpu.parallel.mesh import dan_tp_spec as jax_dan_tp_spec
from drn_wsod_tpu.solver import build_optimizer as jax_build_optimizer
from test_torch_common import TOY, cfg_pair, flatten, jax_batch, unflatten
from test_torch_mask_rcnn import SMALL_HEADS, _dense_batch
from test_torch_retinanet import TOY as RETINA_TOY
from test_torch_retinanet import INSTANT, _batch as _retina_batch
from test_torch_sem_seg import SEM_YAML, sem_batch
from test_torch_sem_seg import TOY as SEM_TOY
from test_torch_supervised import _gt_batch
from test_torch_train_slice import _batch as _slice_batch
from test_torch_train_slice import _models
from test_torch_wsod_heads import _batch as _whole_batch
from torch_dist_worker import finish, launch, rpn_toy, start

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 1e-7
PARAM_ATOL = 1e-6
STEPS = 3
FLAG_DROPOUT = ("MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
                "MODEL.ROI_BOX_HEAD.DROPOUT", 0.5)


def _global(builder, step):
    """The global batch of step ``step``: two builder batches of 2
    images, rank-major."""
    return pmesh.rank_major([builder(2 * step), builder(2 * step + 1)])


def _port(*overrides, yaml=None):
    kw = {} if yaml is None else {"yaml": yaml}
    return cfg_pair(*overrides, **kw)[1]


# family: (port cfg, batch builder, step kind)
FAMILIES = {
    "wsddn": (lambda: _port(*TOY, *FLAG_DROPOUT, "MODEL.ROI_HEADS.NAME",
                            "WSDDNROIHeads"), _slice_batch, "plain"),
    "oicr": (lambda: _port(*TOY, *FLAG_DROPOUT, "WSL.REFINE_REG",
                           [False, False, True]), _slice_batch, "plain"),
    "pcl": (lambda: _port(*TOY, *FLAG_DROPOUT, "MODEL.ROI_HEADS.NAME",
                          "PCLROIHeads"), _whole_batch, "plain"),
    "csc": (lambda: _port(*TOY, *FLAG_DROPOUT, "MODEL.ROI_HEADS.NAME",
                          "CSCROIHeads", "MODEL.BACKBONE.FREEZE_AT", 2),
            _whole_batch, "csc"),
    "fast_rcnn": (lambda: _port(*TOY, *FLAG_DROPOUT, "MODEL.ROI_HEADS.NAME",
                                "StandardROIHeads",
                                "MODEL.BACKBONE.FREEZE_AT", 2),
                  _gt_batch, "plain"),
    "cascade": (lambda: _port(*TOY, *FLAG_DROPOUT, "MODEL.ROI_HEADS.NAME",
                              "CascadeROIHeads", "MODEL.BACKBONE.FREEZE_AT",
                              2, "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG",
                              True), _gt_batch, "plain"),
    "mask": (lambda: _port(*TOY, *FLAG_DROPOUT, *SMALL_HEADS,
                           "MODEL.ROI_HEADS.NAME", "StandardROIHeads",
                           "MODEL.MASK_ON", True), _dense_batch, "plain"),
    "keypoint": (lambda: _port(*TOY, *FLAG_DROPOUT, *SMALL_HEADS,
                               "MODEL.ROI_HEADS.NAME", "StandardROIHeads",
                               "MODEL.KEYPOINT_ON", True), _dense_batch,
                 "plain"),
    "retinanet": (lambda: _port(*RETINA_TOY, "MODEL.DTYPE", "float32",
                                yaml=INSTANT), _retina_batch, "plain"),
    "rpn": (lambda: _port(*TOY), _retina_batch, "rpn"),
    "semantic": (lambda: _port(*SEM_TOY, "MODEL.DTYPE", "float32",
                               yaml=SEM_YAML), sem_batch, "plain"),
    "oicr_split": (lambda: _port(*TOY, *FLAG_DROPOUT), _slice_batch,
                   "plain"),
    # the global-norm clip, on: the shards' squares summed over the model
    # group
    "oicr_split_clip": (lambda: _port(*TOY, *FLAG_DROPOUT,
                                      "SOLVER.CLIP_GRADIENTS.ENABLED", True,
                                      "SOLVER.CLIP_GRADIENTS.CLIP_TYPE",
                                      "norm",
                                      "SOLVER.CLIP_GRADIENTS.CLIP_VALUE",
                                      0.05), _slice_batch, "plain"),
    "oicr_k_steps": (lambda: _port(*TOY, *FLAG_DROPOUT), _slice_batch,
                     "multi"),
}
STEPS_OF = {"keypoint": 1}   # see the module docstring
CSC_TAU = 0.0       # every present class's map live on random weights
K = 2               # the chunked step's K (STEPS + 1 batches: 2 chunks)


def _model(cfg, kind):
    if kind == "rpn":
        m = rpn_toy()
        m.init_weights(torch.Generator().manual_seed(0))
        return m
    return drn_wsod_torch.build_model(cfg, device="cpu")


def _one_process(cfg, kind, state_dict, batches):
    """The reference: the plain (csc, multi) step of one process on the
    global batches; (metrics per step, final state dict)."""
    model = _model(cfg, kind)
    model.load_state_dict(state_dict)
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    from drn_wsod_torch.engine import trainer as tr

    if kind == "csc":
        step = tr.make_csc_train_step(model, tx, tau=CSC_TAU)
    else:
        step = tr.make_train_step(model, tx)
    metrics = []
    if kind == "multi":
        multi = tr.make_multi_train_step(step)
        for i in range(0, len(batches), K):
            state, m = multi(state, batches[i:i + K], 0)
            metrics += [{n: float(v[j]) for n, v in m.items()}
                        for j in range(len(batches[i:i + K]))]
    else:
        for b in batches:
            state, m = step(state, b, 0)
            metrics.append({n: float(v) for n, v in m.items()})
    return metrics, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """Every family at world 2 in one spawn, with their one-process
    references; also a (1, 2) checkpoint and a load of a world-1 one."""
    work = tmp_path_factory.mktemp("families")
    cases, refs, todo = {}, {}, []
    for name, (make_cfg, builder, kind) in FAMILIES.items():
        cfg = make_cfg()
        n = STEPS + 1 if kind == "multi" else STEPS_OF.get(name, STEPS)
        batches = [_global(builder, s) for s in range(n)]
        todo.append((name, cfg, kind, batches))
        split = name.startswith("oicr_split")
        cases[name] = {
            "kind": "rpn" if kind == "rpn" else "steps",
            "cfg": cfg.dump(), "state_dict": None,
            "batches": [b.tensors() for b in batches],
            "axes": ("data", "model") if split else ("data",),
            "shape": (1, 2) if split else (2,),
            "step": kind if kind in ("csc", "multi") else "plain",
            "tau": CSC_TAU, "k": K}
        if name == "oicr_split":
            cases[name]["save_dir"] = str(work / "split_ckpt")
    # a world-1 checkpoint after the reference's first step, loaded by
    # (1, 2) ranks that take the remaining steps
    cfg = FAMILIES["oicr_split"][0]()
    batches = [_global(_slice_batch, s) for s in range(STEPS)]
    model = drn_wsod_torch.build_model(cfg, device="cpu")
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    state, _ = drn_wsod_torch.make_train_step(model, tx)(state, batches[0], 0)
    Checkpointer(str(work / "world1_ckpt")).save(state, state.step)
    cases["split_loads_world1"] = {
        **cases["oicr_split"], "load_dir": str(work / "world1_ckpt"),
        "batches": [b.tensors() for b in batches[1:]]}
    cases["split_loads_world1"].pop("save_dir")
    ranks = start({"cases": cases}, 2, work / "run")
    # the references while the ranks run; the ranks build the same seeded
    # init themselves
    for name, cfg, kind, batches in todo:
        refs[name] = _one_process(cfg, kind, _model(cfg, kind).state_dict(),
                                  batches)
    return finish(ranks, timeout=240), refs, work


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _check_state(got_sd, want_sd, what):
    """Rank 0's trainable parameters and buffers against the reference."""
    assert got_sd and set(got_sd) <= set(want_sd)
    for k, g in got_sd.items():
        w = want_sd[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if w.is_floating_point():
            _close(g.numpy(), w.numpy(), f"{what} {k}", PARAM_ATOL)
        else:
            assert torch.equal(g, w), k


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_family_matches_one_process(families, name):
    results, refs, _ = families
    want_metrics, want_sd = refs[name]
    for rank, res in enumerate(results):
        got = res[name]
        assert len(got["metrics"]) == len(want_metrics)
        for s, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
            assert set(g) == set(w), s
            for k in w:
                assert np.isfinite(g[k]), (k, s)
                _close(g[k], w[k], f"{name} {k} step {s} rank {rank}")
    _check_state(results[0][name]["state_dict"], want_sd, name)
    # parameters and buffers bit-equal across the ranks after every step
    assert results[0][name]["digests"] == results[1][name]["digests"]
    assert len(results[0][name]["digests"]) == (
        -(-len(want_metrics) // K) if name == "oicr_k_steps"
        else len(want_metrics))


FOUR_RANKS = ("wsddn", "oicr")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """WSDDN and OICR data-parallel over four ranks, one image a rank
    (dropout 0.5), in one spawn, with their one-process references."""
    work = tmp_path_factory.mktemp("four_ranks")
    cases, todo = {}, []
    for name in FOUR_RANKS:
        make_cfg, builder, _ = FAMILIES[name]
        cfg = make_cfg()
        batches = [_global(builder, s) for s in range(STEPS)]
        todo.append((name, cfg, batches))
        cases[name] = {"kind": "steps", "cfg": cfg.dump(),
                       "state_dict": None,
                       "batches": [b.tensors() for b in batches],
                       "axes": ("data",), "shape": (4,)}
    ranks = start({"cases": cases}, 4, work)
    refs = {name: _one_process(cfg, "plain", _model(cfg, "plain")
                               .state_dict(), batches)
            for name, cfg, batches in todo}
    return finish(ranks, timeout=240), refs


@pytest.mark.parametrize("name", FOUR_RANKS)
def test_four_ranks_of_one_image_match_one_process(four_ranks, name):
    """``("data",) = (4,)`` at one image a rank against one process on
    the global batch of 4, at the families' tolerances; every rank's
    parameters and buffers bit-equal after every step."""
    results, refs = four_ranks
    want_metrics, want_sd = refs[name]
    for rank, res in enumerate(results):
        for s, (g, w) in enumerate(zip(res[name]["metrics"], want_metrics)):
            assert set(g) == set(w), s
            for k in w:
                _close(g[k], w[k], f"{name} {k} step {s} rank {rank}")
    _check_state(results[0][name]["state_dict"], want_sd, name)
    assert len({tuple(r[name]["digests"]) for r in results}) == 1


def test_split_really_splits_the_dan(families):
    results, _, _ = families
    full = results[0]["oicr_split"]["state_dict"]
    for rank, res in enumerate(results):
        got = res["oicr_split"]
        assert got["split"] == {"box_head.fc1.weight": 0,
                                "box_head.fc1.bias": 0,
                                "box_head.fc2.weight": 1}
        local = got["local"]
        assert local["box_head.fc1.weight"].shape[0] * 2 == \
            full["box_head.fc1.weight"].shape[0]
        assert torch.equal(local["box_head.fc1.weight"],
                           full["box_head.fc1.weight"].chunk(2, 0)[rank])
        assert torch.equal(local["box_head.fc2.weight"],
                           full["box_head.fc2.weight"].chunk(2, 1)[rank])
        assert "box_head.fc2.bias" not in local


def test_split_checkpoint_loads_at_world_1(families):
    """The checkpoint the (1, 2) ranks wrote (rank 0 alone) holds full
    Detectron2 shapes and loads into one process to the ranks' gathered
    tensors, the momentum traces included."""
    results, _, work = families
    ck = Checkpointer(str(work / "split_ckpt"))
    assert ck.all_steps() == [STEPS]
    cfg = FAMILIES["oicr_split"][0]()
    model = drn_wsod_torch.build_model(cfg, device="cpu")
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = ck.load(drn_wsod_torch.create_train_state(model, tx))
    got = results[0]["oicr_split"]
    loaded = model.state_dict()
    for k, v in got["state_dict"].items():
        assert torch.equal(loaded[k], v), k
    assert loaded["box_head.fc1.weight"].shape == (64, 7 * 7 * 512)
    for k, v in state.opt_state["trace"].items():
        assert torch.equal(v, got["opt_trace"][k]), k
    assert state.step == STEPS


def test_world_1_checkpoint_loads_into_the_split(families):
    """(1, 2) ranks resumed from a world-1 checkpoint of step 1 end where
    the one-process reference ends after step 3."""
    results, refs, _ = families
    want_metrics, want_sd = refs["oicr_split"]
    for res in results:
        got = res["split_loads_world1"]
        for g, w in zip(got["metrics"], want_metrics[1:]):
            for k in w:
                _close(g[k], w[k], k)
    _check_state(results[0]["split_loads_world1"]["state_dict"], want_sd,
                 "resumed split")


# ------------------------------------------------------- against JAX
def _jax_reference(axes, shape, batches):
    """The JAX package's sharded step on a mesh of the virtual devices;
    (metrics per step, final params as port tensors); and the port model
    with the same weights."""
    jm, flat, pm, jax_cfg, port_cfg = _models()
    variables = {"params": unflatten(flat)}
    tx = jax_build_optimizer(jax_cfg, variables)
    mesh = jax_create_mesh(axes, shape)
    state = jax_create_state(variables, tx)
    state = jax.device_put(state, jax_state_shardings(state, mesh))
    step = jax_sharded(jm, tx, mesh, state=state)
    metrics = []
    for b in batches:
        state, m = step(state, jax_shard_batch(jax_batch(b), mesh),
                        jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    want = drn_wsod_torch.params_from_jax(flatten(
        jax.device_get(state.params)["params"]))
    return metrics, want, pm, port_cfg


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("axes,shape", [(("data",), (2,)),
                                        (("data",), (4,)),
                                        (("data", "model"), (2, 2))],
                         ids=["data_2", "data_4", "data_model_2x2"])
def test_sharded_step_matches_jax_mesh(tmp_path, axes, shape):
    batches = [_global(_slice_batch, s) for s in range(STEPS)]
    want_metrics, want, pm, port_cfg = _jax_reference(axes, shape, batches)
    world = int(np.prod(shape))
    results = launch({"cases": {"jax": {
        "kind": "steps", "cfg": port_cfg.dump(),
        "state_dict": pm.state_dict(), "batches": [b.tensors()
                                                   for b in batches],
        "axes": axes, "shape": shape}}}, world, tmp_path, timeout=240)
    trainable = {n for n, p in pm.named_parameters() if p.requires_grad}
    for n in trainable:
        _close(results[0]["jax"]["state_dict"][n].numpy(), want[n].numpy(),
               n, PARAM_ATOL)
    for rank, res in enumerate(results):
        got = res["jax"]
        for s, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
            assert set(g) == set(w)
            for k in w:
                _close(g[k], w[k], f"{k} step {s} rank {rank}")
        if len(shape) == 2:
            assert set(got["split"]) == {"box_head.fc1.weight",
                                         "box_head.fc1.bias",
                                         "box_head.fc2.weight"}
    assert len({r["jax"]["digests"][-1] for r in results}) == 1


# ------------------------------------------------------------ unit rules
@pytest.mark.parametrize("name,shape,size", [
    ("box_head.fc1.weight", (64, 3136), 2),
    ("box_head.fc1.bias", (64,), 2),
    ("box_head.fc2.weight", (64, 64), 2),
    ("box_head.fc2.bias", (64,), 2),
    ("box_head.fc3.weight", (30, 64), 4),
    ("box_head.fc3.bias", (30,), 4),
    ("box_head.fc4.weight", (64, 30), 3),
    ("box_head.0.fc1.weight", (64, 3136), 2),
    ("box_predictor.cls.weight", (20, 64), 2),
    ("box_head.fc1.weight", (64, 3136), 1),
])
def test_dan_tp_spec_is_the_jax_rule(name, shape, size):
    """The port's rule on Detectron2 names (torch (out, in) weights)
    against the JAX package's on flax paths ((in, out) kernels)."""
    m = __import__("re").match(r"(.*)\.fc(\d+)\.(weight|bias)$", name)
    if m and m.group(1) == "box_head":
        kind = "kernel" if m.group(3) == "weight" else "bias"
        path = f"['box_head']['fc{m.group(2)}']['{kind}']"
    else:
        path = "['box_predictor']['cls']['kernel']"
    jshape = tuple(reversed(shape)) if name.endswith("weight") else shape
    want = jax_dan_tp_spec(path, jshape, "model", size) if size > 1 else None
    got = pmesh.dan_tp_spec(name, shape, size)
    if want is None:
        assert got is None
    else:
        jdim = [i for i, a in enumerate(want) if a == "model"][0]
        assert got == (len(shape) - 1 - jdim if name.endswith("weight")
                       else jdim)


def test_create_mesh_without_a_group():
    """One process: -1 takes the one rank, no shard, and a mesh needing
    more ranks fails JAX's assert."""
    mesh = pmesh.create_mesh(("data",), (-1,))
    assert mesh.shape == {"data": 1} and mesh.shard is None
    assert (mesh.data_rank, mesh.data_size, mesh.model_size) == (0, 1, 1)
    mesh = pmesh.create_mesh(("data", "model"), (-1, 1))
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(AssertionError, match="needs 2 devices"):
        pmesh.create_mesh(("data", "model"), (1, 2))
    with pytest.raises(ValueError, match="meaning"):
        pmesh.create_mesh(("batch",))


def test_shard_batch_and_rank_major():
    b = _global(_slice_batch, 0)
    blocks = [pmesh.shard_batch(b, pmesh.Mesh(
        ("data",), {"data": 2}, context.StepShard(None, r, 2)))
        for r in range(2)]
    assert all(x.image.shape[0] == 2 for x in blocks)
    back = pmesh.rank_major(blocks)
    for k, v in b.tensors().items():     # NaN boxes in the padded slots
        np.testing.assert_array_equal(back.tensors()[k].numpy(), v.numpy(),
                                      err_msg=k)
    one = pmesh.create_mesh()
    assert pmesh.shard_batch(b, one) is b


def test_one_process_step_unchanged():
    """Without a process group the sharded step is the plain step, bit for
    bit, dropout on; the context helpers are the identity."""
    cfg = FAMILIES["oicr"][0]()
    batches = [_global(_slice_batch, s) for s in range(2)]
    sd = drn_wsod_torch.build_model(cfg, device="cpu").state_dict()
    want_metrics, want_sd = _one_process(cfg, "plain", sd, batches)
    model = drn_wsod_torch.build_model(cfg, device="cpu")
    model.load_state_dict(sd)
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    step = ptp.make_sharded_train_step(model, tx, pmesh.create_mesh(),
                                       state=state)
    for b, w in zip(batches, want_metrics):
        state, m = step(state, b, 0)
        assert {k: float(v) for k, v in m.items()} == w
    for k, v in model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    assert context.active() is None
    t = torch.tensor([3.0])
    assert context.global_sum(t) is t and context.batch_size(4) == 4
    assert isinstance(model.box_head, DiscriminativeAdaptionNeck)
    assert model.box_head.split is None
    infer = ptp.make_sharded_inference_fn(model, pmesh.create_mesh())
    got, want = infer(batches[0]), model.inference_scores(batches[0])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
