"""The port's solver against the JAX package's ``build_optimizer`` (optax):
a small parameter tree under the flax names, carried to the port through
``params_from_jax``, updated with the same numpy gradients for 20 steps.

Covers linear and constant warmup, the multistep and cosine schedules,
BIAS_LR_FACTOR and WEIGHT_DECAY_BIAS, frozen labels (FrozenBN leaves and
backbone stages below FREEZE_AT), ITER_SIZE 2, clipping by value and by
global norm (per parameter group), Nesterov and the bfloat16 momentum
trace. Tolerance: rtol 1e-6, atol 1e-7 per step (float32; the same update
order, only the schedule's float32 arithmetic runs in numpy instead of XLA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.solver import build as port_solver
from drn_wsod_tpu.solver import build as ref_solver
from test_torch_common import cfg_pair, flatten, unflatten

RTOL, ATOL = 1e-6, 1e-7
STEPS = 20

# flax name -> shape: frozen stem and FrozenBN leaves, a res2 and a res3
# stage (FREEZE_AT 2 trains res3), and head weights and biases
TREE = {
    "backbone.stem.conv1.kernel": (3, 3, 3, 4),
    "backbone.stem.conv1_norm.weight": (4,),
    "backbone.stem.conv1_norm.bias": (4,),
    "backbone.stem.conv1_norm.running_mean": (4,),
    "backbone.stem.conv1_norm.running_var": (4,),
    "backbone.res2_0.conv1.kernel": (1, 1, 4, 6),
    "backbone.res3_0.conv1.kernel": (3, 3, 6, 5),
    "backbone.res3_0.shortcut.kernel": (1, 1, 6, 5),
    "backbone.res3_0.conv1_norm.running_var": (5,),
    "box_head.fc1.kernel": (12, 7),
    "box_head.fc1.bias": (7,),
    "box_predictor.cls.kernel": (7, 3),
    "box_predictor.cls.bias": (3,),
    "box_refinery_0.cls_score.kernel": (7, 4),
    "box_refinery_0.cls_score.bias": (4,),
}

BASE = ("SOLVER.BASE_LR", 0.05, "SOLVER.WEIGHT_DECAY", 1e-3,
        "SOLVER.WEIGHT_DECAY_BIAS", 1e-4, "SOLVER.BIAS_LR_FACTOR", 2.0,
        "SOLVER.STEPS", (8, 14), "SOLVER.GAMMA", 0.1,
        "SOLVER.WARMUP_ITERS", 5, "SOLVER.WARMUP_FACTOR", 0.01,
        "SOLVER.WARMUP_METHOD", "linear", "SOLVER.MAX_ITER", 25)
CASES = {
    "multistep_linear_warmup": (),
    "constant_warmup": ("SOLVER.WARMUP_METHOD", "constant"),
    "cosine": ("SOLVER.LR_SCHEDULER_NAME", "WarmupCosineLR"),
    "frozen_at_2": ("MODEL.BACKBONE.FREEZE_AT", 2),
    "iter_size_2": ("WSL.ITER_SIZE", 2, "MODEL.BACKBONE.FREEZE_AT", 2),
    "clip_value": ("SOLVER.CLIP_GRADIENTS.ENABLED", True,
                   "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 0.3),
    "clip_global_norm": ("SOLVER.CLIP_GRADIENTS.ENABLED", True,
                         "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                         "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 1.5),
    "nesterov": ("SOLVER.NESTEROV", True),
    "bf16_momentum": ("SOLVER.MOMENTUM_DTYPE", "bfloat16"),
    "no_momentum": ("SOLVER.MOMENTUM", 0.0),
}


def _tree(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in sorted(TREE.items())}


def _port(flat: dict) -> dict:
    return {k: v.clone() for k, v in
            drn_wsod_torch.params_from_jax(flat).items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_optax(case):
    jax_cfg, port_cfg = cfg_pair(*BASE, *CASES[case])
    init = _tree(0)
    variables = {"params": unflatten(init)}
    tx = ref_solver.build_optimizer(jax_cfg, variables)
    opt_state = tx.init(variables)

    @jax.jit
    def ref_step(variables, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, variables)
        return optax.apply_updates(variables, updates), opt_state

    params = _port(init)
    sgd = port_solver.build_optimizer(port_cfg, params)
    trainable = {n: p for n, p in params.items()
                 if sgd.labels[n] != "frozen"}
    assert all(not params[n].requires_grad for n in params
               if n not in trainable)
    state = sgd.init(trainable)
    # gradients large enough that the clips bind on some steps only
    for step in range(STEPS):
        grads = _tree(100 + step, scale=0.2 + 0.1 * (step % 5))
        variables, opt_state = ref_step(variables, opt_state,
                                        {"params": unflatten(grads)})
        sgd.update({n: g for n, g in _port(grads).items() if n in trainable},
                   state, trainable)
        want = drn_wsod_torch.params_from_jax(
            flatten(variables["params"]))
        for n, p in params.items():
            np.testing.assert_allclose(p.numpy(), want[n].numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{n} after step {step}")
    for n, p in params.items():
        moved = not torch.equal(p, _port(init)[n])
        assert moved == (n in trainable), n
    if "MOMENTUM_DTYPE" in str(CASES[case]):
        assert {t.dtype for t in state["trace"].values()} == {torch.bfloat16}


def test_clip_by_global_norm_is_per_group():
    """Each group's norm alone: a large bias gradient scales the biases,
    not the weights."""
    g_w = [torch.full((3,), 0.1)]
    g_b = [torch.full((3,), 10.0)]
    out_w = port_solver.clip_by_global_norm(g_w, 1.0)
    out_b = port_solver.clip_by_global_norm(g_b, 1.0)
    assert torch.equal(out_w[0], g_w[0])
    torch.testing.assert_close(out_b[0].norm(), torch.tensor(1.0))


@pytest.mark.parametrize("freeze_at", [0, 1, 2, 5])
def test_param_labels_match_jax(freeze_at):
    variables = {"params": unflatten(_tree(0))}
    want = flatten(ref_solver.make_param_labels(variables, freeze_at)[
        "params"])
    got = port_solver.make_param_labels(
        [drn_wsod_torch.checkpoint.from_jax.port_name(k) for k in want],
        freeze_at)
    assert list(got.values()) == list(want.values())


@pytest.mark.parametrize("name", ["WarmupMultiStepLR", "WarmupCosineLR"])
@pytest.mark.parametrize("method", ["linear", "constant"])
def test_schedules_match_jax(name, method):
    jax_cfg, port_cfg = cfg_pair(*BASE, "SOLVER.LR_SCHEDULER_NAME", name,
                                 "SOLVER.WARMUP_METHOD", method)
    ref = ref_solver.build_lr_schedule(jax_cfg)
    got = port_solver.build_lr_schedule(port_cfg)
    for it in range(30):
        np.testing.assert_allclose(got(it), float(ref(jnp.int32(it))),
                                   rtol=RTOL, err_msg=f"iteration {it}")
