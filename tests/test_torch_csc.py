"""The port's CSC (``drn_wsod_torch/ops/csc.py``) against the JAX package's
``drn_wsod_tpu/ops/csc.py``, on the CPU, from seeded numpy inputs.

Exact against the JAX functions run op by op (each operation rounded once,
as IEEE arithmetic gives it): ``integral_image``, ``csc_pool_class`` on
blob maps with boxes on, around and away from the blobs (half-pixel
coordinates included), ``_normalize_class_weights`` in each sign case, and
``csc_forward``'s W, PL and NL. Against the same functions under ``jax.jit``
within rtol 1e-6 only: XLA's CPU compiler turns ``x / 1.8`` into
``x * float32(1 / 1.8)`` and ``x / sqrt(a)`` into ``x * rsqrt(a)`` with an
rsqrt within 1 ulp, so the compiled JAX function is an ulp off its own
source in places. ``csc_loss`` within rtol 1e-6. The CPG maps of the toy
model (R18, DAN [64, 64], float32) against ``compute_cpg_batched`` over
the JAX model's ``proposal_scores``: live at ``FREEZE_AT 2`` (within 1e-5
of each map's max, which is 1), zero at ``FREEZE_AT 5``, where the JAX
package stops the gradient at the backbone's output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.models.heads.wsddn import image_probs
from drn_wsod_torch.ops import csc as tc
from drn_wsod_tpu.ops import csc as jc
from test_torch_common import jax_batch, unflatten
from test_torch_train_slice import _models

torch.set_num_threads(1)

RTOL = 1e-6


def _blob_maps(rs, N, H, W):
    """(N, H, W) max-normalised sums of 3 Gaussian blobs each."""
    yy, xx = np.mgrid[:H, :W]
    maps = np.zeros((N, H, W), np.float32)
    for n in range(N):
        for _ in range(3):
            cy, cx, s = rs.uniform(0, H), rs.uniform(0, W), rs.uniform(2, 9)
            maps[n] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        maps[n] /= maps[n].max()
    return maps


def _rois(rs, N, P, H, W):
    """Boxes anywhere, partly off the image, some at half-pixel coordinates
    (round half to even), some covering nearly the whole image (their
    context clips away, so their contrast is positive)."""
    x1 = rs.uniform(-6, W, (N, P))
    y1 = rs.uniform(-6, H, (N, P))
    rois = np.stack([x1, y1, x1 + rs.uniform(1, 40, (N, P)),
                     y1 + rs.uniform(1, 40, (N, P))], -1)
    rois[:, :P // 5] = np.round(rois[:, :P // 5] * 2) / 2
    rois[:, -3:] = [[1, 2, W - 2, H - 1], [0, 0, W - 1, H - 1],
                    [3, 0, W - 4, H - 3]]
    return rois.astype(np.float32)


def _forward_inputs(seed=0, B=2, C=5, H=48, W=64, P=300):
    rs = np.random.RandomState(seed)
    cpg = _blob_maps(rs, B * C, H, W).reshape(B, C, H, W)
    rois = _rois(rs, B, P, H, W)
    labels = (rs.uniform(size=(B, C)) < 0.6).astype(np.float32)
    labels[:, 0] = 1.0
    preds = rs.uniform(0.01, 0.99, (B, C)).astype(np.float32)
    mask = rs.uniform(size=(B, P)) > 0.1
    return cpg, labels, preds, rois, mask


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _op_by_op(fn, *args):
    with jax.disable_jit():
        return fn(*[jnp.asarray(a) for a in args])


def test_integral_image_equal():
    rs = np.random.RandomState(1)
    binary = (_blob_maps(rs, 3, 40, 56) >= 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jc.integral_image))(binary))
    np.testing.assert_array_equal(tc.integral_image(*_t(binary)).numpy(), want)


def test_csc_pool_class_on_blobs():
    rs = np.random.RandomState(2)
    N, H, W, P = 4, 48, 64, 200
    binary = (_blob_maps(rs, N, H, W) >= 0.1).astype(np.float32)
    ii = np.cumsum(np.cumsum(binary, 1), 2).astype(np.float32)
    rois = _rois(rs, N, P, H, W)
    got = tc.csc_pool_class(*_t(ii, rois)).numpy()
    want = np.asarray(_op_by_op(jax.vmap(jc.csc_pool_class), ii, rois))
    np.testing.assert_array_equal(got, want)
    want_jit = np.asarray(jax.jit(jax.vmap(jc.csc_pool_class))(ii, rois))
    np.testing.assert_allclose(got, want_jit, rtol=RTOL,
                               atol=RTOL * np.abs(want_jit).max())
    assert (got > 0).any() and (got < 0).any() and (got == 0).any()


@pytest.mark.parametrize("case", ["pos_neg", "pos_only", "neg_only",
                                  "all_positive", "zeros"])
def test_normalize_class_weights(case):
    rs = np.random.RandomState(3)
    w = rs.randn(3, 50).astype(np.float32)
    if case == "pos_only":
        w = np.abs(w)
        w[:, 7] = 0.0
    elif case == "neg_only":
        w = -np.abs(w)
    elif case == "all_positive":
        w = np.abs(w) + 0.1
    elif case == "zeros":
        w = np.zeros_like(w)
    pred = rs.uniform(0.05, 0.95, 3).astype(np.float32)
    got = tc._normalize_class_weights(*_t(w, pred)).numpy()
    want = np.asarray(_op_by_op(jax.vmap(jc._normalize_class_weights),
                                w, pred))
    np.testing.assert_array_equal(got, want)
    blended = not np.allclose(got, 1.0)
    assert blended == (case in ("pos_neg", "pos_only"))


def test_csc_forward_w_exact():
    cpg, labels, preds, rois, mask = _forward_inputs()
    W, PL, NL = tc.csc_forward(*_t(cpg, labels, preds, rois, mask))
    want = _op_by_op(jax.vmap(jc.csc_forward), cpg, labels, preds, rois, mask)
    Wj = np.asarray(want[0])
    np.testing.assert_array_equal(W.numpy(), Wj)
    np.testing.assert_array_equal(PL.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(NL.numpy(), np.asarray(want[2]))
    want_jit = np.asarray(jax.jit(jax.vmap(jc.csc_forward))(
        *[jnp.asarray(a) for a in (cpg, labels, preds, rois, mask)])[0])
    np.testing.assert_allclose(W.numpy(), want_jit, rtol=RTOL, atol=RTOL)
    # the input exercises the weights: not all ones where classes are present
    for b in range(len(labels)):
        present = Wj[b][mask[b]][:, labels[b] > 0.5]
        assert (present != 1.0).mean() > 0.5
        assert (Wj[b][mask[b]][:, labels[b] < 0.5] == 1.0).all()


def test_csc_loss():
    cpg, labels, preds, rois, mask = _forward_inputs(seed=4)
    W = np.array(jax.vmap(jc.csc_forward)(
        *[jnp.asarray(a) for a in (cpg, labels, preds, rois, mask)])[0])
    W[0, :20] *= -1.0                    # some negative weight mass too
    rs = np.random.RandomState(5)
    scores = (rs.dirichlet(np.ones(W.shape[1]), (2, W.shape[2]))
              .transpose(0, 2, 1) * 0.9).astype(np.float32)
    neg = np.zeros_like(labels)
    for mean_loss in (True, False):
        want = jax.jit(jc.csc_loss, static_argnums=4)(
            *[jnp.asarray(a) for a in (scores, W, labels, neg)], mean_loss)
        got = tc.csc_loss(*_t(scores, W, labels, neg), mean_loss)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.item(), float(w), rtol=RTOL)
            assert float(w) > 0


def _cpg_pair(freeze_at):
    """(port maps, JAX maps) of the toy model's proposal scores, tau 0."""
    jm, flat, pm, _, _ = _models("MODEL.ROI_HEADS.NAME", "CSCROIHeads",
                                 "MODEL.BACKBONE.FREEZE_AT", freeze_at)
    b = drn_wsod_torch.synthetic_batch(2, 64, 64, 16, 20, seed=3,
                                       device="cpu")
    b.proposal_mask[:, -3:] = False
    variables = {"params": unflatten(flat)}
    jb = jax_batch(b)

    def score_fn(img):
        return jm.apply(variables, jb.replace(image=img),
                        method="proposal_scores")

    preds_j = jnp.asarray(image_probs(pm.proposal_scores(b)).detach().numpy())
    want = np.asarray(jax.jit(lambda im: jc.compute_cpg_batched(
        score_fn, im, jb.labels, preds_j, 0.0))(jb.image))
    got = tc.compute_cpg_batched(
        lambda im: pm.proposal_scores(b.replace(image=im)), b.image,
        b.labels, torch.from_numpy(np.array(preds_j)), 0.0)
    return got.numpy(), want, b.labels.numpy() > 0.5


def test_cpg_maps_live_at_freeze_at_2():
    got, want, present = _cpg_pair(2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    maps = got[present]
    assert len(maps) >= 2 and np.allclose(maps.max((1, 2)), 1.0)
    assert ((maps >= 0.1).mean((1, 2)) > 0.05).all()
    assert (got[~present] == 0).all()


def test_cpg_maps_zero_at_freeze_at_5():
    got, want, _ = _cpg_pair(5)
    assert (want == 0).all() and (got == 0).all()


@pytest.mark.parametrize("form", ["batched", "single"])
def test_cpg_of_a_patch_score_matches_jax(form):
    """``compute_cpg_batched`` and ``compute_cpg`` over a score function
    whose class c reads one image patch (JAX's ``tests/test_csc.py`` toy):
    each map lives on its patch, and a class below ``tau`` is zeroed."""
    rs = np.random.RandomState(6)
    B, H, W, P = 2, 8, 8, 3
    image = rs.uniform(0, 2, (B, H, W, 3)).astype(np.float32)
    labels = np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)
    preds = np.array([[0.9, 0.5], [0.8, 0.9]], np.float32)

    def jax_scores(img):
        sq = img * img
        per = jnp.stack([sq[:, :4, :4].sum((1, 2, 3)),
                         sq[:, 4:, 4:].sum((1, 2, 3))], -1)
        return jnp.tile(per[:, None], (1, P, 1)) / P

    def port_scores(img):
        sq = img * img
        per = torch.stack([sq[:, :4, :4].sum((1, 2, 3)),
                           sq[:, 4:, 4:].sum((1, 2, 3))], -1)
        return per[:, None].expand(-1, P, -1) / P

    if form == "batched":
        want = np.asarray(jc.compute_cpg_batched(
            jax_scores, jnp.asarray(image), jnp.asarray(labels),
            jnp.asarray(preds), 0.7))
        got = tc.compute_cpg_batched(port_scores, *_t(image, labels, preds),
                                     0.7).numpy()
    else:
        want = np.stack([np.asarray(jc.compute_cpg(
            lambda im: jax_scores(im[None])[0], jnp.asarray(image[b]), 2,
            jnp.asarray(labels[b]), jnp.asarray(preds[b]), 0.7))
            for b in range(B)])
        got = np.stack([tc.compute_cpg(
            lambda im: port_scores(im[None])[0], *_t(image[b]), 2,
            *_t(labels[b], preds[b]), 0.7).numpy() for b in range(B)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0, 0, :4, :4].min() > 0 and (got[0, 0, 4:, 4:] == 0).all()
    assert (got[0, 1] == 0).all() and (got[1, 1] == 0).all()   # tau, absent
