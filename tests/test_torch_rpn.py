"""The RPN and RRPN functions against the JAX package's
``models/proposal_generator.py``, on the CPU, the JAX functions jitted.

* ``StandardRPNHead`` with flax's weights through ``params_from_jax``
  (``conv``, ``objectness_logits``, ``anchor_deltas`` -> ``rpn_head.*``)
  over 2 levels: float32 within 1e-5 of the largest output, bfloat16
  within 2e-2 (a bf16 conv rounds differently from XLA's).
* ``rpn_losses`` and ``rrpn_losses`` fed JAX's own ``jax.random.uniform``
  draws as keys: the sampled anchors equal to the JAX sampler's (its
  match and ``jax.lax.top_k`` on the same keys), the losses within rtol
  1e-5. The GT keeps every anchor's IoU 1e-4 from the matcher's 0.3 and
  0.7, and for RRPN's low-quality match each GT's best anchor 1e-4 above
  its second: the port's IoU and the jitted JAX one may round to opposite
  sides of a threshold or of a tie (ROADMAP.md section 3). So the RRPN
  anchors here turn by (-60, 0, 60) degrees: at Detectron2's (-90, 0, 90)
  every anchor has a geometric twin (a square turned 90 degrees, or the
  other ratio turned 90), which ties with it at every IoU.
* ``select_proposals`` and ``select_proposals_rotated`` at toy sizes: the
  same proposals in the same order, boxes within 1e-4 (the decode's
  ``exp`` and the rotated corners are not XLA's), scores equal; no IoU
  among the candidates lies within 1e-5 of the NMS threshold.
* ``generate_rotated_anchors`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.models import proposal_generator as ppg
from drn_wsod_torch.structures import boxes as pboxes
from drn_wsod_torch.structures import rotated_boxes as prot
from drn_wsod_tpu.models import proposal_generator as jpg
from drn_wsod_tpu.ops.matcher import match as jax_match
from drn_wsod_tpu.structures import boxes as jboxes
from drn_wsod_tpu.structures import rotated_boxes as jrot
from test_torch_common import (load_prefixed, param_shapes, random_params,
                               unflatten)

torch.set_num_threads(1)

SIZES, RATIOS, ANGLES = (16.0, 32.0), (0.5, 1.0, 2.0), (-90.0, 0.0, 90.0)
TWINLESS = (-60.0, 0.0, 60.0)
BATCH = 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_matches_flax(dtype):
    rs = np.random.RandomState(0)
    feats = [rs.randn(2, 8, 8, 12).astype(np.float32),
             rs.randn(2, 4, 4, 12).astype(np.float32)]
    jdt = jnp.dtype(dtype)
    jh = jpg.StandardRPNHead(num_anchors=3, conv_dim=16, dtype=jdt)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(
        lambda: jh.init(key, [jnp.asarray(f) for f in feats])), seed=1)
    assert set(flat) == {f"{m}.{p}" for m in ("conv", "objectness_logits",
                                              "anchor_deltas")
                         for p in ("kernel", "bias")}
    want = jh.apply({"params": unflatten(flat)},
                    [jnp.asarray(f).astype(jdt) for f in feats])
    head = ppg.StandardRPNHead(12, 3, 16, dtype=getattr(torch, dtype))
    load_prefixed(head, flat, "", "rpn_head.")
    got = head([torch.from_numpy(f).permute(0, 3, 1, 2).to(
        getattr(torch, dtype)) for f in feats])
    tol = 1e-5 if dtype == "float32" else 2e-2
    for (go, gd), (wo, wd) in zip(got, want):
        for g, w in ((go, wo), (gd, wd)):
            assert g.dtype == torch.float32
            w = np.asarray(w, np.float32)
            g = g.permute(0, 2, 3, 1).detach().numpy()
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * np.abs(w).max())
    assert got[0][1].shape == (2, 12, 8, 8) and got[1][0].shape == (2, 3, 4, 4)


def test_head_init_as_flax():
    head = ppg.StandardRPNHead(12, 3, 64)
    head.init_weights(torch.Generator().manual_seed(0))
    for m in (head.objectness_logits, head.anchor_deltas):
        assert abs(float(m.weight.detach().std()) - 0.01) < 2e-3
        assert not m.bias.any()
    assert abs(float(head.conv.weight.detach().std()) - (9 * 12) ** -0.5) \
        < 0.02


def test_rotated_anchors_bit_equal():
    want = np.asarray(jpg.generate_rotated_anchors((5, 7), 8, SIZES, RATIOS,
                                                   ANGLES))
    got = ppg.generate_rotated_anchors((5, 7), 8, SIZES, RATIOS, ANGLES)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def _keys(seed, n):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    u = [np.array(jax.random.uniform(k, (n,))) for k in (k1, k2)]
    return jax.random.PRNGKey(seed), tuple(torch.from_numpy(v) for v in u)


def _jax_sampled(quality, gt_valid, seed, allow_low_quality):
    """The JAX sampler's indices: ``rpn_losses``' match and top-k steps
    (:85-95) on its own keys."""
    def f(q, v):
        midx, mlab = jax_match(q, v, [0.3, 0.7], [0, -1, 1],
                               allow_low_quality=allow_low_quality)
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        n = q.shape[1]
        pos = jnp.where(mlab == 1, jax.random.uniform(k1, (n,)), -1.0)
        neg = jnp.where(mlab == 0, jax.random.uniform(k2, (n,)), -1.0)
        pv, pi = jax.lax.top_k(pos, BATCH // 2)
        nv, ni = jax.lax.top_k(neg, BATCH - BATCH // 2)
        return jnp.concatenate([pi, ni]), jnp.concatenate([pv >= 0, nv >= 0])
    sel, valid = jax.jit(f)(jnp.asarray(quality), jnp.asarray(gt_valid))
    return np.asarray(sel), np.asarray(valid)


def _clear_of_thresholds(iou, gt_valid, ties: bool):
    iou = iou[gt_valid]
    if (np.abs(iou[..., None] - np.array([0.3, 0.7])) < 1e-4).any():
        return False
    if ties:
        top2 = np.sort(iou, axis=1)[:, -2:]
        return bool((top2[:, 1] - top2[:, 0] > 1e-4).all())
    return True


def _rpn_inputs(seed):
    anchors = ppg.generate_anchors((8, 8), 8, SIZES, RATIOS)
    n = anchors.shape[0]
    rs = np.random.RandomState(seed)
    while True:
        xy = rs.uniform(0, 40, (3, 2))
        wh = rs.uniform(10, 30, (3, 2))
        gt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        gt_valid = np.array([True, True, False])
        iou = pboxes.pairwise_iou(torch.from_numpy(gt).double(),
                                  anchors.double()).numpy()
        if _clear_of_thresholds(iou, gt_valid, ties=False) and \
                (iou[gt_valid] >= 0.7).any():
            break
    logits = rs.randn(n).astype(np.float32)
    deltas = (rs.randn(n, 4) * 0.2).astype(np.float32)
    return anchors, logits, deltas, gt, gt_valid


@pytest.mark.parametrize("seed", [0, 1])
def test_rpn_losses_match_jax(seed):
    anchors, logits, deltas, gt, gt_valid = _rpn_inputs(seed)
    rng, keys = _keys(seed, anchors.shape[0])
    want = jax.jit(jpg.rpn_losses, static_argnames="batch_size")(
        jnp.asarray(anchors.numpy()), logits, deltas, gt, gt_valid, rng,
        batch_size=BATCH)
    lo, ll, (sel, sv, sp) = ppg.rpn_losses(
        anchors, torch.from_numpy(logits), torch.from_numpy(deltas),
        torch.from_numpy(gt), torch.from_numpy(gt_valid), keys,
        batch_size=BATCH, return_sampled=True)
    q = np.asarray(jboxes.pairwise_iou(gt, anchors.numpy()))
    jsel, jvalid = _jax_sampled(q, gt_valid, seed, False)
    assert np.array_equal(sel.numpy(), jsel)
    assert np.array_equal(sv.numpy(), jvalid)
    assert 0 < int(sp.sum()) < int(sv.sum())
    np.testing.assert_allclose(float(lo), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(float(ll), float(want[1]), rtol=1e-5)
    assert float(ll) > 0


def _rrpn_inputs(seed):
    anchors = ppg.generate_rotated_anchors((8, 8), 8, (16.0,), RATIOS,
                                           TWINLESS)
    n = anchors.shape[0]
    rs = np.random.RandomState(seed)
    while True:
        gt = np.stack([rs.uniform(12, 52, 3), rs.uniform(12, 52, 3),
                       rs.uniform(10, 24, 3), rs.uniform(10, 24, 3),
                       rs.uniform(-20, 20, 3)], 1).astype(np.float32)
        gt_valid = np.array([True, True, False])
        iou = prot.pairwise_iou_rotated(torch.from_numpy(gt).double(),
                                        anchors.double()).numpy()
        if _clear_of_thresholds(iou, gt_valid, ties=True):
            break
    logits = rs.randn(n).astype(np.float32)
    deltas = (rs.randn(n, 5) * 0.2).astype(np.float32)
    return anchors, logits, deltas, gt, gt_valid


@pytest.mark.parametrize("seed", [0, 1])
def test_rrpn_losses_match_jax(seed):
    anchors, logits, deltas, gt, gt_valid = _rrpn_inputs(seed)
    rng, keys = _keys(seed, anchors.shape[0])
    want = jax.jit(jpg.rrpn_losses, static_argnames="batch_size")(
        jnp.asarray(anchors.numpy()), logits, deltas, gt, gt_valid, rng,
        batch_size=BATCH)
    lo, ll, (sel, sv, sp) = ppg.rrpn_losses(
        anchors, torch.from_numpy(logits), torch.from_numpy(deltas),
        torch.from_numpy(gt), torch.from_numpy(gt_valid), keys,
        batch_size=BATCH, return_sampled=True)
    q = np.asarray(jax.jit(jrot.pairwise_iou_rotated)(gt, anchors.numpy()))
    jsel, jvalid = _jax_sampled(q, gt_valid, seed, True)
    assert np.array_equal(sel.numpy(), jsel)
    assert np.array_equal(sv.numpy(), jvalid)
    assert int(sp.sum()) >= 2
    np.testing.assert_allclose(float(lo), float(want[0]), rtol=1e-5)
    np.testing.assert_allclose(float(ll), float(want[1]), rtol=1e-5)


def _nms_clear(iou, thr=0.7):
    return bool((np.abs(iou - thr) > 1e-5).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_select_proposals_match_jax(seed):
    anchors = ppg.generate_anchors((8, 8), 8, SIZES, RATIOS)
    n = anchors.shape[0]
    rs = np.random.RandomState(100 + seed)
    while True:
        logits = rs.randn(n).astype(np.float32)
        logits[rs.randint(0, n, 3)] = -np.inf
        deltas = (rs.randn(n, 4) * 0.3).astype(np.float32)
        b = pboxes.clip(pboxes.apply_deltas(torch.from_numpy(deltas).double(),
                                            anchors.double(), (1.0,) * 4),
                        (64, 64))
        top = torch.sort(torch.from_numpy(logits), descending=True,
                         stable=True).indices[:32]
        if _nms_clear(pboxes.pairwise_iou(b[top], b[top]).numpy()):
            break
    f = jax.jit(jpg.select_proposals, static_argnames=(
        "image_hw", "pre_nms_topk", "post_nms_topk"))
    wb, ws, wv = f(jnp.asarray(anchors.numpy()), logits, deltas,
                   image_hw=(64, 64), pre_nms_topk=32, post_nms_topk=8)
    gb, gs, gv = ppg.select_proposals(
        anchors, torch.from_numpy(logits), torch.from_numpy(deltas),
        (64, 64), pre_nms_topk=32, post_nms_topk=8)
    assert gb.shape == (8, 4)
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-4)
    assert 0 < int(gv.sum())


@pytest.mark.parametrize("seed", [0, 1])
def test_select_proposals_rotated_match_jax(seed):
    anchors = ppg.generate_rotated_anchors((8, 8), 8, (16.0,), RATIOS,
                                           ANGLES)
    n = anchors.shape[0]
    rs = np.random.RandomState(200 + seed)
    while True:
        logits = rs.randn(n).astype(np.float32)
        deltas = (rs.randn(n, 5) * 0.3).astype(np.float32)
        deltas[:, :2] *= 4     # some centres leave the image, then clipped
        b = prot.apply_deltas_rotated(torch.from_numpy(deltas).double(),
                                      anchors.double())
        b[:, 0].clamp_(0, 64)
        b[:, 1].clamp_(0, 48)
        top = torch.sort(torch.from_numpy(logits), descending=True,
                         stable=True).indices[:32]
        if _nms_clear(prot.pairwise_iou_rotated(b[top], b[top]).numpy()):
            break
    f = jax.jit(jpg.select_proposals_rotated, static_argnames=(
        "image_hw", "pre_nms_topk", "post_nms_topk"))
    wb, ws, wv = f(jnp.asarray(anchors.numpy()), logits, deltas,
                   image_hw=(48, 64), pre_nms_topk=32, post_nms_topk=8)
    gb, gs, gv = ppg.select_proposals_rotated(
        anchors, torch.from_numpy(logits), torch.from_numpy(deltas),
        (48, 64), pre_nms_topk=32, post_nms_topk=8)
    assert gb.shape == (8, 5)
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-4)
    v = gv.numpy()
    assert v.any() and (gb.numpy()[v, 0] <= 64).all()
