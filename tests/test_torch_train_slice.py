"""The port's train step as a whole against the JAX package's
``make_train_step``, on the CPU: the toy flagship config (R18, DAN [64, 64],
float32, dropout 0: the two frameworks draw different masks), the same
weights through ``params_from_jax``, the same batches of two 64x64 images
with 16 proposal slots, the last 3 padded (NaN boxes, inf objectness), the
flagship YAML's solver (BASE_LR 0.01, momentum 0.9, WD 5e-4,
BIAS_LR_FACTOR 2, WD_BIAS 0), 4 steps.

Every named loss at every step and the final trainable parameters agree
within rtol 1e-4 and atol 1e-5 (float32; convolution and matrix-product
summation orders differ: the largest relative difference seen is about
2e-7); frozen parameters and buffers stay bit-unchanged.

Also: the float32 master parameters of a bfloat16 model keep an SGD update
that bfloat16 storage would round away, as the JAX package keeps it."""

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_tpu.engine import create_train_state as jax_create_state
from drn_wsod_tpu.engine import make_train_step as jax_train_step
from drn_wsod_tpu.models import build_model as jax_build_model
from drn_wsod_tpu.solver import build_optimizer as jax_build_optimizer
from test_torch_common import (TOY, cfg_pair, flatten, jax_batch,
                               param_shapes, random_params, unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STEPS = 4
CASES = {
    "oicr_refine_reg": ("WSL.REFINE_REG", [False, False, True]),
    "wsddn": ("MODEL.ROI_HEADS.NAME", "WSDDNROIHeads"),
}
LOSS_WEIGHTS = {"oicr_refine_reg": {"loss_cls": 2.0, "loss_box_reg_r2": 0.5},
                "wsddn": None}


def _batch(seed):
    b = drn_wsod_torch.synthetic_batch(2, 64, 64, 16, 20, seed=seed,
                                       device="cpu")
    b.proposal_mask[:, -3:] = False
    b.proposals[:, -3:] = float("nan")
    b.objectness[:, -3:] = float("inf")
    return b


def _models(*overrides, weights=None):
    """(jax model, flat flax params, port model, jax cfg, port cfg)."""
    jax_cfg, port_cfg = cfg_pair(*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
                                 "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0,
                                 *overrides)
    jm = jax_build_model(jax_cfg)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(_batch(0)),
        train=False)), seed=1)
    if weights:
        flat.update(weights(flat))
    pm = drn_wsod_torch.build_model(port_cfg, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    return jm, flat, pm, jax_cfg, port_cfg


def _jax_steps(jm, flat, jax_cfg, batches, loss_weights=None):
    variables = {"params": unflatten(flat)}
    tx = jax_build_optimizer(jax_cfg, variables)
    state = jax_create_state(variables, tx)
    step = jax.jit(jax_train_step(jm, tx, loss_weights))
    metrics = []
    for b in batches:
        state, m = step(state, jax_batch(b), jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_steps(pm, port_cfg, batches, loss_weights=None):
    tx = drn_wsod_torch.build_optimizer(port_cfg, pm)
    state = drn_wsod_torch.create_train_state(pm, tx)
    step = drn_wsod_torch.make_train_step(pm, tx, loss_weights)
    metrics = []
    for b in batches:
        state, m = step(state, b, 0)
        metrics.append({k: v.item() for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectories(request):
    jm, flat, pm, jax_cfg, port_cfg = _models(*CASES[request.param])
    batches = [_batch(s) for s in range(STEPS)]
    frozen = {n: t.clone() for n, t in pm.state_dict().items()
              if n.startswith("backbone.")}
    weights = LOSS_WEIGHTS[request.param]
    jax_state, jax_metrics = _jax_steps(jm, flat, jax_cfg, batches, weights)
    port_state, port_metrics = _port_steps(pm, port_cfg, batches, weights)
    return (request.param, jax_state, jax_metrics, port_state, port_metrics,
            frozen)


def test_losses_match_at_every_step(trajectories):
    case, _, jax_metrics, _, port_metrics, _ = trajectories
    names = {"wsddn": {"loss_cls", "total_loss"},
             "oicr_refine_reg": {"loss_cls", "loss_cls_r0", "loss_cls_r1",
                                 "loss_cls_r2", "loss_box_reg_r2",
                                 "total_loss"}}[case]
    for step, (want, got) in enumerate(zip(jax_metrics, port_metrics)):
        assert set(got) == set(want) == names
        for k in want:
            assert np.isfinite(got[k]), (k, step)
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} step {step}")


def test_final_trainable_params_match(trajectories):
    _, jax_state, _, port_state, _, _ = trajectories
    want = drn_wsod_torch.params_from_jax(flatten(jax_state.params["params"]))
    model = port_state.model
    trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trainable and all(not n.startswith("backbone.") for n in trainable)
    sd = model.state_dict()
    for n in trainable:
        assert sd[n].dtype == torch.float32
        np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    assert port_state.step == STEPS


def test_frozen_params_bit_unchanged(trajectories):
    *_, port_state, _, frozen = trajectories
    sd = port_state.model.state_dict()
    for n, t in frozen.items():
        assert torch.equal(sd[n], t), n


def test_multi_step_matches_single_steps():
    """make_multi_train_step over K batches == K single steps, with
    dropout on (the per-step seed depends only on the step count)."""
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "MODEL.DTYPE", "float32"])
    batches = [_batch(s) for s in range(3)]
    runs = []
    for multi in (False, True):
        model = drn_wsod_torch.build_model(cfg, device="cpu")
        tx = drn_wsod_torch.build_optimizer(cfg, model)
        state = drn_wsod_torch.create_train_state(model, tx)
        step = drn_wsod_torch.make_train_step(model, tx)
        if multi:
            state, m = drn_wsod_torch.make_multi_train_step(step)(
                state, batches, 5)
        else:
            ms = [step(state, b, 5)[1] for b in batches]
            m = {k: torch.stack([x[k] for x in ms]) for k in ms[0]}
        runs.append((m, model.state_dict()))
    (m0, sd0), (m1, sd1) = runs
    assert m0.keys() == m1.keys() and all(m1[k].shape == (3,) for k in m1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


def test_dropout_masks_follow_the_seed():
    _, _, pm, _, port_cfg = _models()
    port_cfg.merge_from_list(["MODEL.ROI_BOX_HEAD.DROPOUT", "0.5"])
    b = _batch(0)
    losses = {}
    for seed in (0, 0, 1):
        model = drn_wsod_torch.build_model(port_cfg, device="cpu")
        model.load_state_dict(pm.state_dict())
        gen = torch.Generator().manual_seed(seed)
        losses.setdefault(seed, []).append(
            model(b, generator=gen)["loss_cls"].item())
    assert losses[0][0] == losses[0][1] != losses[1][0]
    with pytest.raises(ValueError, match="generator"):
        model(b)
    assert model(b, train=False)["loss_cls"].item() == pytest.approx(
        _models()[2](b, train=True)["loss_cls"].item(), rel=1e-5)


def test_float32_masters_keep_updates_below_bf16_resolution():
    """bfloat16 model, the DAN biases at 0.1 (one bf16 ulp there is 2^-11),
    a learning rate small enough that one step moves each bias by less
    than half an ulp: bfloat16 storage would round every update away. The
    port keeps float32 masters and moves them as the JAX package (float32
    params, bfloat16 compute) does."""
    def dan_biases(flat):
        return {k: np.full_like(v, 0.1) for k, v in flat.items()
                if k.startswith("box_head.") and k.endswith(".bias")}

    jm, flat, pm, jax_cfg, port_cfg = _models(
        "MODEL.DTYPE", "bfloat16", "SOLVER.BASE_LR", 1e-4,
        weights=dan_biases)
    assert pm.box_head.fc1.bias.dtype == torch.float32
    assert pm.backbone.stem.conv1.weight.dtype == torch.bfloat16
    b = [_batch(0)]
    before = {n: getattr(pm.box_head, n).bias.detach().float().clone()
              for n in ("fc1", "fc2")}
    jax_state, _ = _jax_steps(jm, flat, jax_cfg, b)
    _port_steps(pm, port_cfg, b)
    want = flatten(jax_state.params["params"])
    half_ulp = 2.0 ** -12
    for name in ("fc1", "fc2"):
        bias = getattr(pm.box_head, name).bias.detach().float()
        got = (bias - before[name]).numpy()
        ref = np.asarray(want[f"box_head.{name}.bias"]) - np.float32(0.1)
        assert np.abs(got).max() < half_ulp
        assert (got != 0).mean() > 0.5, name     # the updates were kept
        np.testing.assert_allclose(got, ref, rtol=0.05,
                                   atol=0.05 * np.abs(ref).max(),
                                   err_msg=name)
