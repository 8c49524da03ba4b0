"""The FPN and deformable OICR configs as a whole against the JAX package,
on the CPU: 3 train steps of the port's ``make_train_step`` against the
JAX ``make_train_step`` from the same weights (``params_from_jax``),
dropout 0, the YAMLs' solver, and ``inference_scores``.

  * FPN (``COCO-Detection/fpn_oicr_WSR_50_1x.yaml`` cut to R18, FPN 16
    channels, DAN [64, 64], float32): ROIAlignV2 over p2-p5 on two 512x512
    images whose proposals span the four levels. ``FREEZE_AT`` 5 stops
    the features' gradient, but the JAX package's labels freeze only the
    norms under an FPN, so the bottom-up and FPN weights decay: the port
    keeps them as float32 masters with zero gradients, and each moves by
    weight decay and momentum alone (a scalar multiple of its start);
    the biases (no bias decay) stay put;
  * deformable (``oicr_WSR_50_DC5_deform_1x.yaml`` cut to a narrow R50,
    float32, random nonzero ``conv2_offset``): modulated deformable
    bottlenecks in res4 and res5, pooled by K1's plain twin.

Tolerance: rtol 1e-4, atol 1e-5 on every loss at every step and on every
trained parameter, as the other trajectories."""

import functools

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (CONFIGS, NARROW_R50, TOY, cfg_pair, flatten,
                               jax_batch, param_shapes, random_params,
                               unflatten)
from test_torch_train_slice import _jax_steps, _port_steps

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STEPS = 3
FPN_YAML = str(CONFIGS / "COCO-Detection" / "fpn_oicr_WSR_50_1x.yaml")
DEFORM_YAML = str(CONFIGS / "PascalVOC-Detection"
                  / "oicr_WSR_50_DC5_deform_1x.yaml")
OICR = {"loss_cls", "loss_cls_r0", "loss_cls_r1", "loss_cls_r2",
        "total_loss"}
CASES = {
    "fpn": (FPN_YAML, TOY + ("MODEL.FPN.OUT_CHANNELS", 16), 512, 80),
    "deform": (DEFORM_YAML, NARROW_R50, 64, 20),
}


def _batch(seed, size, classes):
    """Two size x size images, 16 slots with the last 3 padded; under
    FPN the proposals' sides run from 10 to the whole image, so that
    every level of p2-p5 takes some."""
    b = drn_wsod_torch.synthetic_batch(2, size, size, 16, classes, seed=seed,
                                       device="cpu")
    if size > 64:
        rng = np.random.RandomState(seed)
        side = np.exp(rng.uniform(np.log(10), np.log(size), (2, 16)))
        x1 = rng.uniform(0, 1, (2, 16)) * (size - side)
        y1 = rng.uniform(0, 1, (2, 16)) * (size - side)
        b.proposals[:] = torch.from_numpy(np.stack(
            [x1, y1, x1 + side, y1 + side], -1).astype(np.float32))
        b.proposals[:, 0] = torch.tensor([0.0, 0.0, size, size])
    b.proposal_mask[:, -3:] = False
    b.proposals[:, -3:] = float("nan")
    b.objectness[:, -3:] = float("inf")
    return b


def _models(case):
    yaml, overrides, size, classes = CASES[case]
    jax_cfg, port_cfg = cfg_pair(*overrides, "MODEL.PIXEL_STD",
                                 [57.4, 57.1, 58.4],
                                 "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0, yaml=yaml)
    jm = jax_build_model(jax_cfg)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(_batch(0, size, classes)),
        train=False)), seed=2)
    pm = drn_wsod_torch.build_model(port_cfg, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    return jm, flat, pm, jax_cfg, port_cfg


@functools.lru_cache(maxsize=None)
def _trajectories(case):
    jm, flat, pm, jax_cfg, port_cfg = _models(case)
    _, _, size, classes = CASES[case]
    batches = [_batch(s, size, classes) for s in range(STEPS)]
    before = {n: t.clone() for n, t in pm.state_dict().items()}
    trainable = {n for n, p in pm.named_parameters() if p.requires_grad}
    jax_state, jax_metrics = _jax_steps(jm, flat, jax_cfg, batches)
    port_state, port_metrics = _port_steps(pm, port_cfg, batches)
    return (case, jax_state, jax_metrics, port_state, port_metrics, before,
            trainable)


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectories(request):
    return _trajectories(request.param)


def test_losses_match_at_every_step(trajectories):
    _, _, jax_metrics, _, port_metrics, _, _ = trajectories
    for step, (want, got) in enumerate(zip(jax_metrics, port_metrics)):
        assert set(got) == set(want) == OICR
        for k in want:
            assert np.isfinite(got[k]), (k, step)
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} step {step}")


def test_trained_params_match_and_frozen_unchanged(trajectories):
    case, jax_state, _, port_state, _, before, trainable = trajectories
    want = drn_wsod_torch.params_from_jax(flatten(jax_state.params["params"]))
    sd = port_state.model.state_dict()
    for n in trainable:
        assert sd[n].dtype == torch.float32
        np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    for n, t in before.items():
        if n not in trainable:
            assert torch.equal(sd[n], t), n
    backbone = {n for n in trainable if n.startswith("backbone.")}
    if case == "deform":
        assert not backbone
        return
    # under FPN every backbone conv weight and bias is in the optimizer
    convs = {n for n, _ in port_state.model.backbone.named_parameters()}
    assert backbone == {f"backbone.{n}" for n in convs}
    assert "backbone.bottom_up.stem.conv1.weight" in backbone
    assert "backbone.fpn_lateral2.bias" in backbone


def test_frozen_fpn_weights_move_by_decay_alone():
    _, _, _, port_state, _, before, _ = _trajectories("fpn")
    sd = port_state.model.state_dict()
    names = [n for n in sd if n.startswith("backbone.")
             and n.endswith(".weight") and ".norm." not in n]
    assert len(names) == 22 + 8          # R18's convs and the FPN's
    for n in names:
        ratio = (sd[n].double() / before[n].double())
        # zero gradients: p_k = p_0 * (a scalar from lr, decay, momentum)
        assert ratio.max() - ratio.min() < 1e-6, n
        assert 0.99997 < ratio.mean() < 0.999995, (n, ratio.mean())
    for n in sd:
        if n.startswith("backbone.") and n.endswith(".bias"):
            assert torch.equal(sd[n], before[n]), n


@pytest.mark.parametrize("case", sorted(CASES))
def test_inference_scores_match(case):
    jm, flat, pm, _, _ = _models(case)
    _, _, size, classes = CASES[case]
    b = _batch(7, size, classes)
    want_s, want_b = jax.jit(lambda v, x: jm.apply(
        v, x, method="inference_scores"))({"params": unflatten(flat)},
                                          jax_batch(b))
    got_s, got_b = pm.inference_scores(b)
    assert got_s.shape == (2, 16, classes + 1)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


def test_fpn_proposals_reach_every_level():
    from drn_wsod_torch.ops.poolers import assign_boxes_to_levels

    levels = set()
    for s in range(STEPS):
        b = _batch(s, 512, 80)
        lv = assign_boxes_to_levels(b.proposals[b.proposal_mask], 2, 5)
        levels |= set(lv.tolist())
    assert levels == {2, 3, 4, 5}
