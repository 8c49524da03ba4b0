"""The Keypoint R-CNN head and its functions against the JAX package, on
the CPU.

  * ``KRCNNConvDeconvUpsampleHead`` against flax's: float32 within rtol
    1e-5 (atol 1e-6 times the largest logit; the 2x bilinear resize is
    ``ops/resize.py``, within 1e-6 of ``jax.image.resize``), bfloat16
    convs within a bfloat16 ulp of the largest;
  * ``keypoints_to_heatmap_targets`` bit-equal, keypoints on the cell and
    box borders, outside the box and unlabelled included;
    ``Keypoints.to_heatmap`` equal to the JAX structure's;
  * ``keypoint_rcnn_loss`` within rtol 1e-6, with no keypoint valid too;
  * ``heatmaps_to_keypoints``: locations bit-equal to the JAX function run
    op by op (compiled, XLA fuses ``x1 + xi / S * w`` into a multiply-add
    and moves some by an ulp) and scores within rtol 1e-6, exact ties
    (the first cell wins in both) included;
  * the mapper's keypoint arm equal to the JAX mapper's: the keypoints
    moved with the resize and the flip, left and right not swapped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.models.heads import keypoint as port_kp
from drn_wsod_torch.structures.keypoints import Keypoints
from drn_wsod_tpu.data.mapper import DatasetMapper as JaxMapper
from drn_wsod_tpu.models.heads import keypoint as jax_kp
from drn_wsod_tpu.structures.keypoints import Keypoints as JaxKeypoints
from test_torch_common import (cfg_pair, flatten, load_prefixed,
                               random_params, unflatten)

torch.set_num_threads(1)
K = 17


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keypoint_head_matches_flax(dtype):
    jm = jax_kp.KRCNNConvDeconvUpsampleHead(
        num_keypoints=K, conv_dims=(32,) * 3,
        dtype=jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    x = np.random.RandomState(0).randn(5, 6, 6, 16).astype(np.float32)
    shapes = {k: v.shape for k, v in flatten(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x))["params"]).items()}
    flat = random_params(shapes, 1)
    want = np.asarray(jm.apply({"params": unflatten(flat)}, x))
    pm = port_kp.KRCNNConvDeconvUpsampleHead(16, K, conv_dims=(32,) * 3,
                                             dtype=dtype)
    load_prefixed(pm, flat, "keypoint_head.", "keypoint_head.")
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (5, 24, 24, K)
    assert got.dtype == np.float32
    top = np.abs(want).max()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * top)
    else:
        assert np.abs(got - want).max() <= 2.0 ** (np.floor(np.log2(top)) - 7)


def _keypoints_and_boxes(seed, N=9, S=56):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 300, (N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 120, (N, 2))], 1)
    boxes[0, 2:] = boxes[0, :2]                      # an empty box
    boxes = boxes.astype(np.float32)
    kp = np.zeros((N, K, 3), np.float32)
    w = np.maximum(boxes[:, 2:3] - boxes[:, 0:1], 1e-6)
    h = np.maximum(boxes[:, 3:4] - boxes[:, 1:2], 1e-6)
    kp[..., 0] = boxes[:, 0:1] + rng.uniform(-0.2, 1.2, (N, K)) * w
    kp[..., 1] = boxes[:, 1:2] + rng.uniform(-0.2, 1.2, (N, K)) * h
    # on cell borders, the box's edges and exactly on its far side
    kp[1, :4, 0] = boxes[1, 0] + np.array([0, 1, 7, S]) / S * w[1, 0]
    kp[2, :3, 1] = boxes[2, 3]
    kp[..., 2] = rng.randint(0, 3, (N, K))
    return kp, boxes


@pytest.mark.parametrize("seed", range(4))
def test_heatmap_targets_bit_equal(seed):
    kp, boxes = _keypoints_and_boxes(seed)
    for S in (56, 16):
        want_t, want_v = jax.jit(
            jax_kp.keypoints_to_heatmap_targets, static_argnums=2)(
                jnp.asarray(kp), jnp.asarray(boxes), S)
        got_t, got_v = port_kp.keypoints_to_heatmap_targets(
            torch.from_numpy(kp), torch.from_numpy(boxes), S)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        assert 0 < got_v.numpy().mean() < 1
    jt, jv = JaxKeypoints(kp).to_heatmap(boxes, 56)
    pt, pv = Keypoints(kp).to_heatmap(boxes, 56)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pv, jv)
    assert len(Keypoints(kp)[2:5]) == 3


def test_keypoint_loss_matches_jax():
    rng = np.random.RandomState(1)
    N, S = 10, 16
    logits = (rng.randn(N, S, S, K) * 4).astype(np.float32)
    tgt = rng.randint(0, S * S, (N, K)).astype(np.int32)
    for valid in (rng.rand(N, K) < 0.5, np.zeros((N, K), bool)):
        want = float(jax.jit(jax_kp.keypoint_rcnn_loss)(
            jnp.asarray(logits), jnp.asarray(tgt), jnp.asarray(valid)))
        got = float(port_kp.keypoint_rcnn_loss(torch.from_numpy(logits),
                                               torch.from_numpy(tgt),
                                               torch.from_numpy(valid)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_heatmaps_to_keypoints_matches_jax():
    rng = np.random.RandomState(2)
    N, S = 8, 16
    logits = rng.randn(N, S, S, K).astype(np.float32)
    logits[0, 3, 5, 0] = logits[0, 9, 1, 0] = 50.0   # an exact tie
    logits[1, :, :, 1] = 0.0                          # all tied
    _, boxes = _keypoints_and_boxes(3, N)
    args = jnp.asarray(logits), jnp.asarray(boxes)
    with jax.disable_jit():
        want = np.asarray(jax_kp.heatmaps_to_keypoints(*args))
    jitted = np.asarray(jax.jit(jax_kp.heatmaps_to_keypoints)(*args))
    got = port_kp.heatmaps_to_keypoints(torch.from_numpy(logits),
                                        torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=1e-6)
    # compiled, XLA contracts x1 + xi / S * w into one fused multiply-add
    np.testing.assert_allclose(got, jitted, rtol=1e-6)
    # the first of the tied cells, as jnp.argmax takes it
    np.testing.assert_array_equal(
        got[0, 0, :2], boxes[0, :2] + (np.array([5.5, 3.5]) / S
                                       * (boxes[0, 2:] - boxes[0, :2])))


def test_mapper_keypoints_match_jax():
    """Keypoint R-CNN's training and test mappers on COCO-format person
    records: (G, 17, 3) keypoints equal to the JAX mapper's, with flips
    among the seeds and no left/right swap."""
    from drn_wsod_torch.tools.make_mask_fixtures import (coco_records,
                                                         synthetic_coco)

    records = coco_records(synthetic_coco(7, 6, keypoints=True))
    overrides = ("MODEL.KEYPOINT_ON", True, "MODEL.ROI_HEADS.NUM_CLASSES", 1,
                 "INPUT.MIN_SIZE_TRAIN", (64, 96), "INPUT.MAX_SIZE_TRAIN",
                 160, "INPUT.MIN_SIZE_TEST", 96, "INPUT.MAX_SIZE_TEST", 160)
    jc, pc = cfg_pair(*overrides)
    flips = 0
    for is_train in (True, False):
        jm, pm = JaxMapper(jc, is_train), drn_wsod_torch.data.DatasetMapper(
            pc, is_train)
        for i, r in enumerate(records):
            got = pm(dict(r), np.random.RandomState(i))
            want = jm(dict(r), np.random.RandomState(i))
            np.testing.assert_array_equal(got["gt_keypoints"],
                                          want["gt_keypoints"])
            assert got["gt_keypoints"].shape == (100, K, 3)
            n = len(r["annotations"])
            raw = np.asarray([a["keypoints"] for a in r["annotations"]],
                             np.float32).reshape(n, K, 3)
            np.testing.assert_array_equal(got["gt_keypoints"][:n, :, 2],
                                          raw[..., 2])
            scale = got["image_hw"][1] / r["width"]
            flipped = not np.allclose(got["gt_keypoints"][:n, :, 0],
                                      raw[..., 0] * scale, atol=1e-2)
            flips += flipped
            assert "gt_masks" not in got
    assert flips >= 1
