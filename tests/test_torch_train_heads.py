"""The training parts of the heads against the JAX package, same numpy
inputs: ``get_deltas``, ``match``, ``wsddn_loss``, OICR pseudo-GT mining,
proposal labelling and the branch losses, and the DAN's dropout.

Integer outputs (seed indices, matched indices and labels, classes) and
gathered boxes are compared exactly; float outputs with rtol 1e-6 and atol
1e-7 (float32; only ``log``/``exp`` and the summation order may differ).
The JAX functions are per image and vmapped; the port's take a batch axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.models.heads import box_head as port_box_head
from drn_wsod_torch.models.heads import oicr as port_oicr
from drn_wsod_torch.models.heads import wsddn as port_wsddn
from drn_wsod_torch.ops.matcher import match as port_match
from drn_wsod_torch.structures import boxes as port_boxes
from drn_wsod_tpu.models.heads import oicr as ref_oicr
from drn_wsod_tpu.models.heads import wsddn as ref_wsddn
from drn_wsod_tpu.ops.matcher import match as ref_match
from drn_wsod_tpu.structures import boxes as ref_boxes

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-7


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _boxes(rng, shape, lo=-20.0, hi=120.0, degenerate=True):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(-10 if degenerate else 2, 60, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_get_deltas_inverts_apply_deltas():
    rng = np.random.RandomState(0)
    src = _boxes(rng, (2, 13))
    tgt = _boxes(rng, (2, 13))
    for w in ((10.0, 10.0, 5.0, 5.0), (1.0, 2.0, 3.0, 4.0)):
        got = port_boxes.get_deltas(_t(src), _t(tgt), w)
        _close(got, ref_boxes.get_deltas(jnp.asarray(src), jnp.asarray(tgt),
                                         w), rtol=1e-6, atol=1e-6)
    good = _boxes(rng, (17,), degenerate=False)
    deltas = port_boxes.get_deltas(_t(good), _t(good[::-1].copy()))
    back = port_boxes.apply_deltas(deltas, _t(good))
    _close(back, good[::-1], rtol=1e-5, atol=1e-4)


MATCH_CASES = ["random", "ties", "no_valid_gt", "partly_valid"]


def _quality(case, rng):
    M, N = 5, 23
    q = rng.uniform(0, 1, (3, M, N)).astype(np.float32)
    valid = np.ones((3, M), bool)
    if case == "ties":
        q = np.round(q * 4) / 4                # many equal values
        q[:, 1] = q[:, 3]                       # identical rows
        q[:, :, 0] = 0.5                        # a threshold tie
    elif case == "no_valid_gt":
        valid[1] = False
    elif case == "partly_valid":
        valid[:, ::2] = False
        q[0, 0] = 2.0                           # invalid rows never win
    return q, valid


@pytest.mark.parametrize("allow_low_quality", [False, True],
                         ids=["plain", "low_quality"])
@pytest.mark.parametrize("case", MATCH_CASES)
def test_match(case, allow_low_quality):
    rng = np.random.RandomState(MATCH_CASES.index(case))
    q, valid = _quality(case, rng)
    for thr, labels in (([0.5], [0, 1]), ([0.3, 0.7], [0, -1, 1])):
        want = jax.vmap(lambda a, b: ref_match(
            a, b, thr, labels, allow_low_quality))(jnp.asarray(q),
                                                   jnp.asarray(valid))
        got = port_match(_t(q), _t(valid), thr, labels, allow_low_quality)
        for g, w in zip(got, want):
            _equal(g, w)


@pytest.mark.parametrize("mean_loss", [True, False], ids=["mean", "sum"])
def test_wsddn_loss(mean_loss):
    rng = np.random.RandomState(1)
    scores = rng.uniform(0, 0.2, (3, 11, 6)).astype(np.float32)
    scores[0, :, 2] = 0.0                       # clamps at 1e-6
    scores[1, :, 3] = 1.0                       # clamps at 1 - 1e-6
    labels = (rng.uniform(0, 1, (3, 6)) > 0.5).astype(np.float32)
    _close(port_wsddn.wsddn_loss(_t(scores), _t(labels), mean_loss),
           ref_wsddn.wsddn_loss(jnp.asarray(scores), jnp.asarray(labels),
                                mean_loss))


def _mining_inputs(seed, class_specific=False):
    rng = np.random.RandomState(seed)
    B, P, C = 2, 31, 6
    scores = rng.uniform(0, 1, (B, P, C)).astype(np.float32)
    scores[0, 4, 1] = scores[0, 9, 1] = 2.0     # tied maximum: first wins
    scores[1, 0, 2] = 5.0                       # the max sits in a pad slot
    mask = rng.uniform(0, 1, (B, P)) > 0.2
    mask[0, [4, 9]] = True
    mask[1, 0] = False
    boxes = _boxes(rng, (B, P, C) if class_specific else (B, P),
                   degenerate=False)
    labels = np.zeros((B, C), np.float32)
    labels[0, [1, 3]] = 1.0
    labels[1, [2]] = 1.0
    evidence = rng.uniform(1e-6, 1, (B, C)).astype(np.float32)
    proposals = _boxes(rng, (B, P), degenerate=False)
    return scores, boxes, mask, labels, evidence, proposals


def _ref_mine(scores, boxes, mask, labels, evidence):
    return jax.vmap(ref_oicr.mine_pgt)(*(jnp.asarray(x) for x in (
        scores, boxes, mask, labels, evidence)))


@pytest.mark.parametrize("class_specific", [False, True],
                         ids=["agnostic", "class_specific"])
def test_mine_pgt(class_specific):
    scores, boxes, mask, labels, evidence, _ = _mining_inputs(
        2, class_specific)
    want = _ref_mine(scores, boxes, mask, labels, evidence)
    got = port_oicr.mine_pgt(_t(scores), _t(boxes), _t(mask), _t(labels),
                             _t(evidence))
    for field in ("boxes", "valid", "weights", "scores"):
        _equal(getattr(got, field), getattr(want, field))
    # the tie resolves to the first index, the padded maximum is skipped
    seed_box = boxes[0, 4, 1] if class_specific else boxes[0, 4]
    assert got.boxes[0, 1].tolist() == seed_box.tolist()
    assert got.scores[1, 2].item() != 5.0


def test_mine_pgt_all_masked_image():
    scores, boxes, mask, labels, evidence, _ = _mining_inputs(3)
    mask[1] = False
    want = _ref_mine(scores, boxes, mask, labels, evidence)
    got = port_oicr.mine_pgt(_t(scores), _t(boxes), _t(mask), _t(labels),
                             _t(evidence))
    for field in ("boxes", "valid", "weights", "scores"):
        _equal(getattr(got, field), getattr(want, field))


def _targets(seed, **kw):
    scores, boxes, mask, labels, evidence, proposals = _mining_inputs(seed)
    # pseudo boxes among the proposals, so that IoU 1 and >= 0.5 occur
    want_pgt = _ref_mine(scores, proposals, mask, labels, evidence)
    want = jax.vmap(lambda g, p, m: ref_oicr.label_proposals(g, p, m, **kw))(
        want_pgt, jnp.asarray(proposals), jnp.asarray(mask))
    pgt = port_oicr.mine_pgt(_t(scores), _t(proposals), _t(mask), _t(labels),
                             _t(evidence))
    got = port_oicr.label_proposals(pgt, _t(proposals), _t(mask), **kw)
    return got, want, proposals, mask


@pytest.mark.parametrize("thresholds", [((0.5,), (0, 1)),
                                        ((0.1, 0.5), (0, -1, 1))],
                         ids=["fg_bg", "with_ignore"])
def test_label_proposals(thresholds):
    got, want, _, mask = _targets(4, iou_thresholds=thresholds[0],
                                  iou_labels=thresholds[1])
    _equal(got.gt_class, want.gt_class)
    _equal(got.weight, want.weight)
    _equal(got.gt_box, want.gt_box)
    gc = got.gt_class.numpy()
    assert (gc[~mask] == -1).all()
    assert (gc[mask] < 6).any() and (gc[mask] == 6).any()
    if thresholds[1][1] == -1:
        assert (gc[mask] == -1).any()


def test_refinement_losses():
    got_t, want_t, proposals, mask = _targets(5)
    rng = np.random.RandomState(6)
    B, P = mask.shape
    logits = rng.randn(B, P, 7).astype(np.float32)
    _close(port_oicr.refinement_loss(_t(logits), got_t),
           ref_oicr.refinement_loss(jnp.asarray(logits), want_t))
    for R in (6, 1):                            # class-specific, agnostic
        deltas = rng.randn(B, P, 4 * R).astype(np.float32)
        for beta in (0.0, 0.5):
            _close(port_oicr.refinement_box_loss(
                _t(deltas), _t(proposals), got_t, _t(mask), 6,
                smooth_l1_beta=beta),
                ref_oicr.refinement_box_loss(
                    jnp.asarray(deltas), jnp.asarray(proposals), want_t,
                    jnp.asarray(mask), 6, smooth_l1_beta=beta),
                rtol=1e-6, atol=1e-6)


def test_refinement_loss_with_no_weight_is_zero():
    got_t, _, _, _ = _targets(5)
    got_t = got_t._replace(weight=torch.zeros_like(got_t.weight))
    loss = port_oicr.refinement_loss(torch.zeros(2, 31, 7), got_t)
    assert loss.item() == 0.0


# ------------------------------------------------------------------ dropout
def test_dropout_identity_without_generator_or_rate():
    x = torch.randn(4, 9)
    assert port_box_head.fast_dropout(x, 0.5, None) is x
    g = torch.Generator().manual_seed(0)
    assert port_box_head.fast_dropout(x, 0.0, g) is x


def test_dropout_half_keeps_or_doubles_and_is_seeded():
    x = torch.rand(1000, 1000) + 0.5
    outs = [port_box_head.fast_dropout(
        x, 0.5, torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    kept = outs[0] != 0
    assert torch.equal(outs[0][kept], 2 * x[kept])
    assert abs(kept.float().mean().item() - 0.5) < 0.01      # 1e6 draws


def test_dropout_other_rate_scales_by_keep_probability():
    x = torch.rand(1000, 1000) + 0.5
    out = port_box_head.fast_dropout(x, 0.25,
                                     torch.Generator().manual_seed(1))
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert abs(kept.float().mean().item() - 0.75) < 0.01


def test_dan_applies_dropout_after_every_fc():
    torch.manual_seed(0)
    dan = port_box_head.DiscriminativeAdaptionNeck(12, (8, 6), dropout=0.5)
    x = torch.randn(50, 12)
    g = torch.Generator().manual_seed(3)
    got = dan(x, g)
    g = torch.Generator().manual_seed(3)
    h = port_box_head.fast_dropout(torch.relu(dan.fc1(x)), 0.5, g)
    want = port_box_head.fast_dropout(torch.relu(dan.fc2(h)), 0.5, g)
    assert torch.equal(got, want)
    assert torch.equal(dan(x), torch.relu(dan.fc2(torch.relu(dan.fc1(x)))))
