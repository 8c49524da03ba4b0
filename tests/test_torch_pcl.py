"""The port's PCL (``drn_wsod_torch/ops/pcl.py``) against the JAX package's
``drn_wsod_tpu/ops/pcl.py`` (jitted, vmapped over images), on the CPU, from
seeded numpy inputs.

Exact (bit for bit): the prefix sums against ``jnp.cumsum``, the 3-means
top members (ties, fewer than 3 valid scores, all-invalid rows), and
``mine_pcl_clusters``'s centers, scores and valid mask (P 64-512, C 4 and
20, several present classes, so later classes lose centers to earlier
ones). ``pcl_loss``, ``pcl_branch_loss`` and the branch loss's gradient
w.r.t. the logits within rtol 1e-5 (float32; softmax and the sums round in
another order), with and without cluster centers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.ops import pcl as tp
from drn_wsod_tpu.ops import pcl as jp

torch.set_num_threads(1)

RTOL = 1e-5

_jax_members = jax.jit(jax.vmap(jp._kmeans3_top_members))
_jax_mine = jax.jit(jax.vmap(jp.mine_pcl_clusters))
_jax_loss = jax.jit(jax.vmap(jp.pcl_loss))


def _boxes(rs, B, P, integer):
    x1 = rs.uniform(0, 180, (B, P))
    y1 = rs.uniform(0, 180, (B, P))
    w = rs.uniform(4, 120, (B, P))
    h = rs.uniform(4, 120, (B, P))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1)
    return (np.round(boxes) if integer else boxes).astype(np.float32)


def _inputs(B, P, C, seed, integer=True, present=0.4):
    """Peaked per-class scores (a few proposals hold most of the mass, as a
    branch's softmax does), some padded slots, several present classes."""
    rs = np.random.RandomState(seed)
    boxes = _boxes(rs, B, P, integer)
    scores = rs.dirichlet(np.full(P, 0.2), (B, C)).transpose(0, 2, 1)
    scores = np.clip(scores * 4, 0, 1).astype(np.float32)
    mask = rs.uniform(size=(B, P)) > 0.1
    labels = (rs.uniform(size=(B, C)) < present).astype(np.float32)
    labels[:, 0] = labels[:, -1] = 1.0
    return boxes, scores, mask, labels


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("shape", [(1,), (16,), (17,), (64,), (4097,),
                                   (3, 513)])
def test_prefix_sums_bit_equal_to_jnp_cumsum(shape):
    x = np.random.RandomState(len(shape) * 7 + shape[-1]).uniform(
        0, 1, shape).astype(np.float32) ** 2
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
    assert np.array_equal(tp.xla_cumsum(torch.from_numpy(x)).numpy(), want)
    if shape[-1] > 1000:
        # why the port does not call torch.cumsum (float64 on the CPU)
        assert not np.array_equal(torch.cumsum(torch.from_numpy(x), -1)
                                  .numpy(), want)


def _member_cases(rs, B=4, P=40):
    scores = rs.uniform(0, 1, (B, P)).astype(np.float32)
    valid = rs.uniform(size=(B, P)) > 0.2
    yield "random", scores, valid
    yield "ties", np.round(scores * 4) / 4, valid            # few levels
    few = valid.copy()
    few[0] = False
    few[1] = False
    few[1, 5] = True
    few[2] = False
    few[2, [3, 9]] = True
    yield "n<3", scores, few                                  # n = 0, 1, 2
    yield "all_invalid", scores, np.zeros_like(valid)
    yield "all_equal", np.full_like(scores, 0.25), valid
    # dense uniform scores: the SSE grid is flat near its optimum, and in
    # one of these 8 rows prefix sums in torch.cumsum's order move the
    # boundary (found by search over seeds; the port's order does not)
    rs5 = np.random.RandomState(5)
    yield ("uniform_512", rs5.uniform(0, 1, (8, 512)).astype(np.float32),
           rs5.uniform(size=(8, 512)) > 0.1)


@pytest.mark.parametrize("case", ["random", "ties", "n<3", "all_invalid",
                                  "all_equal", "uniform_512"])
def test_kmeans3_top_members_equal(case):
    cases = {name: (s, v) for name, s, v in
             _member_cases(np.random.RandomState(3))}
    scores, valid = cases[case]
    want = np.asarray(_jax_members(*_j(scores, valid)))
    got = tp._kmeans3_top_members(*_t(scores, valid)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "n<3":
        assert got[0].sum() == 0 and got[1].sum() == 1 and got[2].sum() == 1


@pytest.mark.parametrize("B,P,C,seed,integer", [
    (2, 64, 4, 0, True), (2, 256, 20, 1, True), (1, 512, 20, 2, True),
    (2, 512, 4, 3, False), (2, 128, 20, 4, False)])
def test_mine_pcl_clusters_equal(B, P, C, seed, integer):
    boxes, scores, mask, labels = _inputs(B, P, C, seed, integer)
    want = _jax_mine(*_j(scores, boxes, mask, labels))
    got = tp.mine_pcl_clusters(*_t(scores, boxes, mask, labels))
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    valid = got.center_valid.numpy()
    # several present classes hold centers
    assert (valid.any(-1).sum(-1) >= 2).all()
    # no proposal is the center of two present classes (the pool shrinks)
    for b in range(B):
        picked = got.centers.numpy()[b][valid[b]]
        assert len({tuple(x) for x in picked}) <= len(picked)


def test_later_classes_lose_centers_to_earlier_ones():
    """Two present classes with the same scores: the second class's pool
    lacks the first's centers, so it picks others (or none)."""
    boxes, scores, mask, labels = _inputs(1, 128, 2, seed=5)
    scores[..., 1] = scores[..., 0]
    labels[:] = 1.0
    want = _jax_mine(*_j(scores, boxes, mask, labels))
    got = tp.mine_pcl_clusters(*_t(scores, boxes, mask, labels))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c, v = got.centers[0].numpy(), got.center_valid[0].numpy()
    first = {tuple(x) for x in c[0][v[0]]}
    assert first and not first & {tuple(x) for x in c[1][v[1]]}


def _logits(rs, B, P, C):
    return (rs.randn(B, P, C + 1) * 2).astype(np.float32)


@pytest.mark.parametrize("centers", ["some", "none"])
def test_pcl_loss_and_branch_loss(centers):
    B, P, C = 2, 96, 20
    boxes, scores, mask, labels = _inputs(B, P, C, seed=6)
    if centers == "none":
        labels[:] = 0.0                       # no present class: plain CE
    logits = _logits(np.random.RandomState(7), B, P, C)
    clusters = _jax_mine(*_j(scores, boxes, mask, labels))
    assert bool(np.asarray(clusters.center_valid).any()) == (centers == "some")
    want = np.asarray(_jax_loss(jnp.asarray(logits), clusters,
                                *_j(boxes, mask)))
    port_clusters = tp.PCLClusters(*(torch.from_numpy(np.array(a))
                                     for a in clusters))
    got = tp.pcl_loss(*_t(logits), port_clusters, *_t(boxes, mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)

    def jax_branch(lg):
        return jp.pcl_branch_loss(lg, *_j(scores, boxes, mask, labels))

    want_l, want_g = jax.jit(jax.value_and_grad(jax_branch))(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got_l = tp.pcl_branch_loss(lg, *_t(scores, boxes, mask, labels))
    got_l.backward()
    np.testing.assert_allclose(got_l.item(), float(want_l), rtol=RTOL)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g),
                               rtol=RTOL,
                               atol=RTOL * np.abs(np.asarray(want_g)).max())
