"""The port's detect path as a whole against the JAX package's, on the CPU:
``inference_scores`` and ``make_detect_fn`` on the toy flagship config (R18,
DAN [64, 64], H = W = 64, P = 64, float32), same weights through
``params_from_jax``, same batch — padded slots poisoned with NaN and inf.

Tolerance: rtol 1e-4 and atol 1e-5 times the largest value compared
(float32; convolution and matrix-product summation orders differ; WSDDN
scores are products of two softmaxes, about 1e-3). Detections must agree
wherever the neighbouring output scores are further apart than that
tolerance."""

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_tpu.evaluation.evaluator import make_detect_fn as jax_detect_fn
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (TOY, cfg_pair, jax_batch, param_shapes,
                               random_params, unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
SCORE_THRESH, NMS_THRESH, TOPK = 1e-5, 0.3, 40

CASES = {
    "oicr": (),
    "wsddn": ("MODEL.ROI_HEADS.NAME", "WSDDNROIHeads"),
    "oicr_refine_reg": ("WSL.REFINE_REG", [False, False, True]),
}


def _batch():
    """The synthetic batch with the last 8 slots of each image padded:
    mask False, NaN/inf boxes and inf objectness."""
    b = drn_wsod_torch.synthetic_batch(2, 64, 64, 64, 20, seed=3,
                                       device="cpu")
    b.proposal_mask[:, -8:] = False
    b.proposals[:, -8:-4] = float("nan")
    b.proposals[:, -4:] = float("inf")
    b.objectness[:, -8:] = float("inf")
    b.orig_hw[1] = torch.tensor([48, 80], dtype=torch.int32)
    return b


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(jax model, jax variables, port model, batch) for one case."""
    # image std brings pixels to O(1), so the random weights give O(1) logits
    jax_cfg, port_cfg = cfg_pair(*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
                                 *CASES[request.param])
    batch = _batch()
    jbatch = jax_batch(batch)
    jm = jax_build_model(jax_cfg)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jbatch, train=False)), seed=1)
    pm = drn_wsod_torch.build_model(port_cfg, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    return jm, {"params": unflatten(flat)}, jbatch, pm, batch


def test_inference_scores_match(pair):
    jm, variables, jbatch, pm, batch = pair
    want_s, want_b = jax.jit(lambda v, b: jm.apply(
        v, b, method="inference_scores"))(variables, jbatch)
    got_s, got_b = pm.inference_scores(batch)
    assert got_s.shape == want_s.shape and got_b.shape == want_b.shape
    assert torch.isfinite(got_s).all() and torch.isfinite(got_b).all()
    assert (got_s[~batch.proposal_mask] == 0).all()
    for got, want in ((got_s, want_s), (got_b, want_b)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())
    # the scores are not trivially uniform
    valid = got_s[batch.proposal_mask]
    assert valid.std() > 0.1 * valid.mean()


def test_detect_fn_matches(pair):
    jm, variables, jbatch, pm, batch = pair
    want = jax_detect_fn(jm, SCORE_THRESH, NMS_THRESH, TOPK)(variables, jbatch)
    got = drn_wsod_torch.make_detect_fn(pm, SCORE_THRESH, NMS_THRESH, TOPK,
                                        device="cpu")(batch)
    want = {k: np.asarray(want[k]) for k in got}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["boxes"].shape == (2, TOPK, 4)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    s = want["scores"]
    atol = ATOL * np.abs(s).max()
    np.testing.assert_allclose(got["scores"], s, rtol=RTOL, atol=atol)
    gap = np.abs(np.diff(s, axis=1)) > atol + RTOL * np.abs(s[:, 1:])
    lone = np.ones_like(s, bool)            # score apart from both neighbours
    lone[:, 1:] &= gap
    lone[:, :-1] &= gap
    assert lone.sum() > TOPK                 # most of the ranking is decided
    np.testing.assert_array_equal(got["classes"][lone], want["classes"][lone])
    np.testing.assert_allclose(got["boxes"][lone], want["boxes"][lone],
                               rtol=RTOL,
                               atol=ATOL * np.abs(want["boxes"]).max())
    assert (got["boxes"][..., 2] <= batch.orig_hw[:, None, 1].numpy()).all()
