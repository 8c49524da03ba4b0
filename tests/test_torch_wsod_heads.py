"""The other WSOD heads and trainable backbone stages against the JAX
package, on the CPU: the toy flagship config of
``tests/test_torch_train_slice.py`` (R18, DAN [64, 64], float32, dropout 0,
the same weights through ``params_from_jax``) with another ROI head or
``FREEZE_AT``, 3 steps of the port's ``make_train_step`` against the JAX
package's:

  * PCL: 3 branches on proposal-cluster targets;
  * OICR at ``FREEZE_AT 2``: res3-res5 train, through the differentiable
    pool.

(The CSC heads' steps, on the helpers here: ``tests/test_torch_csc_step.py``.)
Each batch's first proposals cover nearly the whole 64x64 image (for CSC:
their context clips away, so their contrast is positive). Tolerance:
``tests/test_torch_train_slice.py``'s rtol 1e-4 and atol 1e-5 on every
loss and metric at every step and on the final trainable parameters; frozen parameters (the stem and res2 at
``FREEZE_AT 2``) stay bit-unchanged.

Also: ``inference_scores`` of PCL (background rotated to the back) and of
CSC; a trainable stage of a bfloat16 model keeps an SGD update below half a
bfloat16 ulp, as the JAX package's float32 masters do; ``build_model`` on
the PCL and CSC YAMLs, and its refusals."""

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_tpu.engine import create_train_state as jax_create_state
from drn_wsod_tpu.engine import make_csc_train_step as jax_csc_step
from drn_wsod_tpu.solver import build_optimizer as jax_build_optimizer
from test_torch_common import (CONFIGS, TOY, flatten, jax_batch, unflatten)
from test_torch_train_slice import _batch as _slice_batch
from test_torch_train_slice import _jax_steps, _models, _port_steps

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STEPS = 3
# the CSC heads' trajectories: tests/test_torch_csc_step.py
CASES = {
    "pcl": ("PCLROIHeads", 5),
    "oicr_freeze_at_2": ("OICRROIHeads", 2),
}
# near-whole-image boxes (64x64 images)
WHOLE = [[2.0, 3.0, 60.0, 61.0], [0.0, 0.0, 63.0, 50.0],
         [10.0, 1.0, 63.0, 63.0], [1.0, 12.0, 55.0, 62.0]]


def _batch(seed):
    b = _slice_batch(seed)
    b.proposals[:, :len(WHOLE)] = torch.tensor(WHOLE)
    return b


def _jax_csc_steps(jm, flat, jax_cfg, batches):
    variables = {"params": unflatten(flat)}
    tx = jax_build_optimizer(jax_cfg, variables)
    state = jax_create_state(variables, tx)
    step = jax.jit(jax_csc_step(jm, tx, tau=0.0))
    metrics = []
    for b in batches:
        state, m = step(state, jax_batch(b), jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _port_csc_steps(pm, port_cfg, batches):
    tx = drn_wsod_torch.build_optimizer(port_cfg, pm)
    state = drn_wsod_torch.create_train_state(pm, tx)
    step = drn_wsod_torch.engine.make_csc_train_step(pm, tx, tau=0.0)
    metrics = []
    for b in batches:
        state, m = step(state, b, 0)
        metrics.append({k: v.item() for k, v in m.items()})
    return state, metrics


def run_case(case, head, freeze_at):
    """3 steps of both packages from the same weights: (case, JAX state,
    JAX metrics, port state, port metrics, trainable names, state dict
    before)."""
    jm, flat, pm, jax_cfg, port_cfg = _models(
        "MODEL.ROI_HEADS.NAME", head, "MODEL.BACKBONE.FREEZE_AT", freeze_at)
    batches = [_batch(s) for s in range(STEPS)]
    trainable = {n for n, p in pm.named_parameters() if p.requires_grad}
    before = {n: t.clone() for n, t in pm.state_dict().items()}
    if head.startswith("CSC"):
        jax_state, jax_metrics = _jax_csc_steps(jm, flat, jax_cfg, batches)
        port_state, port_metrics = _port_csc_steps(pm, port_cfg, batches)
    else:
        jax_state, jax_metrics = _jax_steps(jm, flat, jax_cfg, batches)
        port_state, port_metrics = _port_steps(pm, port_cfg, batches)
    return (case, jax_state, jax_metrics, port_state, port_metrics,
            trainable, before, freeze_at)


def check_losses_and_metrics(trajectories):
    case, _, jax_metrics, _, port_metrics, *_ = trajectories
    image_loss = ({"loss_cls_pos", "loss_cls_neg", "csc/W_pos_mean",
                   "csc/W_neg_mean", "csc/pred_mean"}
                  if case.startswith("csc") else {"loss_cls"})
    branches = ({"loss_cls_r0", "loss_cls_r1", "loss_cls_r2"}
                if case in ("pcl", "csc_oicr", "oicr_freeze_at_2") else set())
    for step, (want, got) in enumerate(zip(jax_metrics, port_metrics)):
        assert set(got) == set(want) == image_loss | branches | {"total_loss"}
        for k in want:
            assert np.isfinite(got[k]), (k, step)
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{k} step {step}")
    if case.startswith("csc"):
        # 13 of 16 slots valid: W = 1 everywhere gives exactly 13 / 16
        w_pos = [m["csc/W_pos_mean"] for m in jax_metrics]
        if case == "csc_freeze_at_5":
            assert w_pos == [13 / 16] * STEPS
        else:
            assert all(w != 13 / 16 for w in w_pos), w_pos


def check_final_trainable_params(trajectories):
    _, jax_state, _, port_state, _, trainable, _, freeze_at = trajectories
    want = drn_wsod_torch.params_from_jax(flatten(jax_state.params["params"]))
    sd = port_state.model.state_dict()
    backbone = {n for n in trainable if n.startswith("backbone.")}
    if freeze_at == 2:
        assert backbone and all(n.startswith(("backbone.res3",
                                              "backbone.res4",
                                              "backbone.res5"))
                                for n in backbone)
    else:
        assert not backbone
    for n in trainable:
        assert sd[n].dtype == torch.float32
        np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    assert port_state.step == STEPS


def check_frozen_unchanged_and_trainable_moved(trajectories):
    *_, port_state, _, trainable, before, _ = trajectories
    sd = port_state.model.state_dict()
    still = {n for n in trainable if torch.equal(sd[n], before[n])}
    # zero gradients, and WEIGHT_DECAY_BIAS is 0: the detection stream's
    # softmax runs over proposals, so a per-class bias leaves it unchanged;
    # no branch regresses boxes (REFINE_REG), so bbox_pred takes no loss
    # (its weights move by weight decay alone)
    assert all(n == "box_predictor.det.bias"
               or n.endswith(".bbox_pred.bias") for n in still), still
    for n, t in before.items():
        if n not in trainable:
            assert torch.equal(sd[n], t), n


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectories(request):
    return run_case(request.param, *CASES[request.param])


def test_losses_and_metrics_match_at_every_step(trajectories):
    check_losses_and_metrics(trajectories)


def test_final_trainable_params_match(trajectories):
    check_final_trainable_params(trajectories)


def test_frozen_params_bit_unchanged_and_trainable_moved(trajectories):
    check_frozen_unchanged_and_trainable_moved(trajectories)


@pytest.mark.parametrize("head", ["PCLROIHeads", "CSCROIHeads"])
def test_inference_scores_match(head):
    jm, flat, pm, _, _ = _models("MODEL.ROI_HEADS.NAME", head)
    b = _batch(7)
    want_s, want_b = jax.jit(lambda v, x: jm.apply(
        v, x, method="inference_scores"))({"params": unflatten(flat)},
                                          jax_batch(b))
    got_s, got_b = pm.inference_scores(b)
    assert got_s.shape == (2, 16, 21)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    if head == "CSCROIHeads":                # WSDDN scores, zero background
        assert (got_s[..., -1] == 0).all()
    else:                                    # PCL: background rotated back
        assert (got_s[:, :13, -1] > 0).all()
    assert (got_s[:, 13:] == 0).all()        # padded slots


def test_trainable_stage_keeps_updates_below_bf16_resolution():
    """bfloat16 model at FREEZE_AT 2 with a learning rate small enough that
    one step moves each res5 conv weight by less than half a bfloat16 ulp:
    the port keeps float32 masters for the trainable stages (the frozen
    stem stays bfloat16) and moves them as the JAX package does."""
    jm, flat, pm, jax_cfg, port_cfg = _models(
        "MODEL.DTYPE", "bfloat16", "MODEL.BACKBONE.FREEZE_AT", 2,
        "SOLVER.BASE_LR", 1e-4)
    w = pm.backbone.res5[0].conv1.weight
    assert w.dtype == torch.float32 and w.requires_grad
    assert pm.backbone.stem.conv1.weight.dtype == torch.bfloat16
    assert pm.backbone.res2[0].conv1.weight.dtype == torch.bfloat16
    before = w.detach().clone()
    b = [_batch(0)]
    jax_state, _ = _jax_steps(jm, flat, jax_cfg, b)
    _port_steps(pm, port_cfg, b)
    got = (w.detach() - before).numpy()
    want_w = drn_wsod_torch.params_from_jax(
        flatten(jax_state.params["params"]))["backbone.res5.0.conv1.weight"]
    ref = (want_w - before).numpy()
    # half a bfloat16 ulp of each weight (8 significant bits)
    half_ulp = 2.0 ** (np.floor(np.log2(np.abs(before.numpy()))) - 8)
    assert (np.abs(got) < half_ulp).mean() > 0.99
    assert (got != 0).mean() > 0.5              # the updates were kept
    np.testing.assert_allclose(got, ref, rtol=0.05,
                               atol=0.05 * np.abs(ref).max())


@pytest.mark.parametrize("name,head,depth,pallas", [
    ("pcl_WSR_50_DC5_1x", "PCL", 50, True),
    ("pcl_WSR_18_DC5_1x", "PCL", 18, True),
    ("csc_WSR_18_DC5_1x", "CSC", 18, False)])
def test_build_model_builds_the_yamls(name, head, depth, pallas):
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(CONFIGS / "PascalVOC-Detection" / f"{name}.yaml"))
    # the YAML's backbone at full width; a narrow DAN keeps fc1 small
    cfg.merge_from_list(["MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]"])
    m = drn_wsod_torch.build_model(cfg, device="cpu")
    assert (m.head_type, m.use_pallas_pooler, m.freeze_backbone) == \
        (head, pallas, True)
    assert len(getattr(m, "box_refinery", ())) == (3 if head == "PCL" else 0)
    assert len(m.backbone.res3) == (2 if depth == 18 else 4)


@pytest.mark.parametrize("overrides,pallas,frozen_stages", [
    (("MODEL.BACKBONE.FREEZE_AT", 3), False, ("stem", "res2", "res3")),
    (("MODEL.ROI_BOX_HEAD.USE_PALLAS_POOLER", False), False,
     ("stem", "res2", "res3", "res4", "res5")),
    (("MODEL.ROI_HEADS.NAME", "CSCOICRROIHeads"), False,
     ("stem", "res2", "res3", "res4", "res5")),
    ((), True, ("stem", "res2", "res3", "res4", "res5"))])
def test_pool_choice_and_frozen_stages(overrides, pallas, frozen_stages):
    _, pc = _cfg(*overrides)
    m = drn_wsod_torch.build_model(pc, device="cpu")
    assert m.use_pallas_pooler == pallas
    frozen = {n.split(".")[0] for n, p in m.backbone.named_parameters()
              if not p.requires_grad}
    assert frozen == set(frozen_stages)


def _cfg(*overrides):
    from test_torch_common import cfg_pair
    return cfg_pair(*TOY, *overrides)


# the ids are those of the cases when both flags raised item 14
@pytest.mark.parametrize("key,value", [
    ("MODEL.MASK_ON", True), ("MODEL.KEYPOINT_ON", True)],
    ids=["MODEL.MASK_ON-True-item 14 (the mask",
         "MODEL.KEYPOINT_ON-True-item 14 (the mask"])
def test_build_model_refuses_what_is_not_ported(key, value):
    """``MASK_ON`` and ``KEYPOINT_ON`` raised "item 14 (the mask ..." here
    until the arms were ported. An OICR head now builds with either flag
    and, as in the JAX package, without a mask or keypoint head, so its
    train step is OICR's; Fast R-CNN and Cascade build the heads
    (``tests/test_torch_mask_rcnn.py``). NORM BN builds
    (``tests/test_torch_bn.py``), and so do the supervised heads and
    deformable blocks (``tests/test_torch_supervised.py``,
    ``tests/test_torch_deform.py``)."""
    _, pc = _cfg(key, value)
    m = drn_wsod_torch.build_model(pc, device="cpu")
    assert m.head_type == "OICR" and getattr(m, key.split(".")[1].lower())
    assert not hasattr(m, "mask_head") and not hasattr(m, "keypoint_head")
    assert {n.split(".")[0] for n, _ in m.named_parameters()} == {
        "backbone", "box_head", "box_predictor", "box_refinery"}
