"""The port's multiclass_nms and rescale_boxes against the JAX package's.

Same score and box inputs must give identical classes, valid flags and
boxes, and scores equal to 1e-6 (they are copies of input scores, so in
practice equal)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.ops.nms import multiclass_nms as port_nms
from drn_wsod_torch.postprocessing import rescale_boxes as port_rescale
from drn_wsod_tpu.ops.nms import multiclass_nms as ref_nms
from drn_wsod_tpu.postprocessing import rescale_boxes as ref_rescale

torch.set_num_threads(1)


def _inputs(case, rng, B=2, P=48, C=4):
    xy = rng.uniform(0, 80, (B, P, 2))
    wh = rng.uniform(4, 40, (B, P, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # clusters of near-duplicates so that suppression chains form
    boxes[:, 1::3] = boxes[:, 0::3][:, :boxes[:, 1::3].shape[1]] + \
        rng.uniform(-2, 2, boxes[:, 1::3].shape).astype(np.float32)
    scores = rng.uniform(0, 1, (B, P, C)).astype(np.float32)
    valid = rng.uniform(0, 1, (B, P)) > 0.15
    kw = dict(iou_threshold=0.3, score_threshold=1e-5, topk=20)
    if case == "class_specific":
        boxes = (boxes[:, :, None, :]
                 + rng.uniform(-3, 3, (B, P, C, 4))).astype(np.float32)
        boxes[0, 5, 1] = np.nan                  # non-finite box: dropped
    elif case == "tied_scores":
        scores = np.round(scores * 4) / 4        # many equal scores
    elif case == "few_candidates":
        valid[:] = False
        valid[:, :3] = True                      # 3 * C < topk candidates
        kw["topk"] = 40
    elif case == "trimmed":
        kw["per_class_topk"] = 8                 # per-class trim is active
        scores[1, 7, 2] = np.inf                 # non-finite score: dropped
    elif case == "high_threshold":
        kw["score_threshold"] = 0.9
    return boxes, scores, valid, kw


CASES = ["class_agnostic", "class_specific", "tied_scores", "few_candidates",
         "trimmed", "high_threshold"]


@pytest.mark.parametrize("case", CASES)
def test_multiclass_nms_matches_jax(case):
    rng = np.random.RandomState(CASES.index(case))
    boxes, scores, valid, kw = _inputs(case, rng)
    want = jax.vmap(functools.partial(ref_nms, **kw))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    got = port_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["valid"].shape == (2, kw["topk"])
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-6)
    if case == "few_candidates":
        assert not got["valid"][:, -1].any()
        assert (got["scores"][~got["valid"]] == 0).all()


def test_rescale_boxes_matches_jax():
    rng = np.random.RandomState(9)
    boxes = rng.uniform(-30, 900, (3, 10, 4)).astype(np.float32)
    image_hw = np.array([[704, 704], [512, 640], [0, 300]], np.int32)
    orig_hw = np.array([[375, 500], [480, 600], [200, 100]], np.int32)
    want = ref_rescale(jnp.asarray(boxes), jnp.asarray(image_hw),
                       jnp.asarray(orig_hw))
    got = port_rescale(torch.from_numpy(boxes), torch.from_numpy(image_hw),
                       torch.from_numpy(orig_hw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
