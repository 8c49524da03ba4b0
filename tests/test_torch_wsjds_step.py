"""The WSJDS train step (the CSC step with the seg branch) against the JAX
package's ``make_csc_train_step``, on the CPU: ``tests/test_modeling.py:
tiny_cfg("WSJDSROIHeads")`` (R18-WS, 4 classes, DAN [32, 32], float32)
with dropout 0, tau 0, 3 steps from the same weights on ``tiny_batch``es
whose first proposals cover nearly the whole 64x64 image (their contrast is
positive, so W moves where the maps are live).

  * ``FREEZE_AT 5``: the JAX package stops the gradient at the backbone's
    output, so the CPG maps are zero and ``seg_loss_from_cpg`` labels every
    pixel background (ROADMAP.md section 3, copied);
  * ``FREEZE_AT 2``: live maps through the trainable stages;
  * ``FREEZE_AT 5`` with ``SEM_SEG_HEAD.CONSTRAINT``: ``loss_constraint``
    too, both frameworks' ``crf_forward`` cut to one iteration (ten take
    JAX minutes to compile inside the step; ``tests/test_torch_crf.py``
    holds the default ten).

Tolerance: ``tests/test_torch_wsod_heads.py``'s rtol 1e-4 and atol 1e-5 on
every loss (``loss_seg`` included) and ``csc/*`` metric at every step and on
the final trainable parameters (the seg head's included); frozen parameters
bit-unchanged."""

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.ops import csc as csc_lib
from drn_wsod_tpu.engine import create_train_state as jax_create_state
from drn_wsod_tpu.engine import make_csc_train_step as jax_csc_step
from drn_wsod_tpu.solver import build_optimizer as jax_build_optimizer
from test_modeling import tiny_batch
from test_torch_common import flatten, unflatten
from test_torch_wsjds import port_batch, tiny_models

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STEPS = 3
WHOLE = np.array([[2.0, 3.0, 60.0, 61.0], [0.0, 0.0, 63.0, 50.0],
                  [10.0, 1.0, 63.0, 63.0], [1.0, 12.0, 55.0, 62.0]],
                 np.float32)
NAMES = {"loss_cls_pos", "loss_cls_neg", "loss_seg", "total_loss",
         "csc/W_pos_mean", "csc/W_neg_mean", "csc/pred_mean"}


def _batch(seed):
    b = tiny_batch(seed=seed)
    proposals = np.array(b.proposals)
    proposals[:, :len(WHOLE)] = WHOLE
    return b.replace(proposals=jax.numpy.asarray(proposals))


CASES = {"freeze_at_5": (5, False), "freeze_at_2": (2, False),
         "constraint": (5, True)}


def _one_crf_iteration(fn):
    def run(probs, image, **kw):
        return fn(probs, image, **{**kw, "max_iter": 1})
    return run


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectories(request):
    from drn_wsod_torch.models.heads import seg as port_seg
    from drn_wsod_tpu.ops import crf as jax_crf

    freeze_at, constraint = CASES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        if constraint:
            mp.setattr(jax_crf, "crf_forward",
                       _one_crf_iteration(jax_crf.crf_forward))
            mp.setattr(port_seg, "crf_forward",
                       _one_crf_iteration(port_seg.crf_forward))
        return _run(freeze_at, constraint)


def _run(freeze_at, constraint):
    jm, flat, pm, jc, pc = tiny_models(
        MODEL__BACKBONE__FREEZE_AT=freeze_at,
        MODEL__ROI_BOX_HEAD__DROPOUT=0.0,
        MODEL__SEM_SEG_HEAD__CONSTRAINT=constraint)
    batches = [_batch(s) for s in range(STEPS)]
    trainable = {n for n, p in pm.named_parameters() if p.requires_grad}
    before = {n: t.clone() for n, t in pm.state_dict().items()}

    variables = {"params": unflatten(flat)}
    tx = jax_build_optimizer(jc, variables)
    jstate = jax_create_state(variables, tx)
    jstep = jax.jit(jax_csc_step(jm, tx, tau=0.0))
    want = []
    for b in batches:
        jstate, m = jstep(jstate, b, jax.random.PRNGKey(0))
        want.append({k: float(v) for k, v in m.items()})

    cpgs = []
    cpg_fn = csc_lib.cpg_from_scores

    def recording(*a, **k):
        cpgs.append(cpg_fn(*a, **k))
        return cpgs[-1]

    ptx = drn_wsod_torch.build_optimizer(pc, pm)
    pstate = drn_wsod_torch.create_train_state(pm, ptx)
    pstep = drn_wsod_torch.engine.make_csc_train_step(pm, ptx, tau=0.0)
    got = []
    csc_lib.cpg_from_scores = recording
    try:
        for b in batches:
            pstate, m = pstep(pstate, port_batch(b), 0)
            got.append({k: v.item() for k, v in m.items()})
    finally:
        csc_lib.cpg_from_scores = cpg_fn
    return (freeze_at, jstate, want, pstate, got, cpgs, trainable, before,
            batches, constraint)


def test_losses_and_metrics_match_at_every_step(trajectories):
    freeze_at, _, want, _, got, cpgs, *_, constraint = trajectories
    assert len(got) == len(want) == len(cpgs) == STEPS
    names = NAMES | ({"loss_constraint"} if constraint else set())
    for step, (w, g) in enumerate(zip(want, got)):
        assert set(g) == set(w) == names
        for k in w:
            assert np.isfinite(g[k]), (k, step)
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} step {step}")
    peaks = [float(c.amax()) for c in cpgs]
    if freeze_at == 5:
        assert peaks == [0.0] * STEPS
    else:
        # the lr saturates the random heads' class softmax after two steps
        # (as in chip_smoke.py phase 13 (b)): live, if faintly, after them
        assert peaks[0] == 1.0 and all(p > 0 for p in peaks), peaks


def test_zero_maps_label_every_pixel_background(trajectories):
    """At FREEZE_AT 5 every target is background and every pixel valid. At
    FREEZE_AT 2 the maps reach the seg resolution live; at this toy size
    (a 64x64 image, a 7x7 seg map) the antialiased resize averages a
    map's single peak of 1 over about 9x9 pixels, far below the 0.5
    foreground threshold (``tests/test_torch_wsjds.py`` holds the targets
    of live maps)."""
    from drn_wsod_torch.models.heads import seg as seg_lib

    freeze_at, *_, cpgs, _, _, batches, _ = trajectories
    for cpg, b in zip(cpgs, batches):
        small = seg_lib.resize_linear(cpg, (2, 4, 7, 7)).permute(0, 2, 3, 1)
        target, valid = seg_lib.seg_targets(small,
                                            torch.from_numpy(
                                                np.array(b.labels)))
        if freeze_at == 5:
            assert valid.all() and (target == 0).all()
        else:
            assert small.amax() > 0


def test_final_trainable_params_match(trajectories):
    freeze_at, jstate, _, pstate, _, _, trainable, *_ = trajectories
    want = drn_wsod_torch.params_from_jax(flatten(jstate.params["params"]))
    sd = pstate.model.state_dict()
    assert {n for n in trainable if n.startswith("seg_head.")}
    backbone = {n for n in trainable if n.startswith("backbone.")}
    assert bool(backbone) == (freeze_at == 2)
    for n in trainable:
        assert sd[n].dtype == torch.float32
        np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    assert pstate.step == STEPS


def test_frozen_params_bit_unchanged(trajectories):
    *_, pstate, _, _, trainable, before, _, _ = trajectories
    sd = pstate.model.state_dict()
    for n, t in before.items():
        if n not in trainable:
            assert torch.equal(sd[n], t), n
    moved = {n for n in trainable if not torch.equal(sd[n], before[n])}
    assert {n for n in trainable if n.startswith("seg_head.")} <= moved
