"""The port's WSJDS segmentation branch (``drn_wsod_torch/models/heads/
seg.py`` and the ``with_seg`` arms of ``models/meta_arch.py``) against the
JAX package's, on the CPU, with ``tests/test_modeling.py:tiny_cfg(
"WSJDSROIHeads")`` (R18-WS, 4 classes, DAN [32, 32], float32) and the same
weights through ``params_from_jax``.

Tolerances:
- ``ASPPSegHead`` logits: float32 rtol 1e-4, atol 1e-5 times the largest
  value compared; bfloat16 ASPP (float32 predictor): atol 2e-2 times it
  (five bfloat16 convs, rounded in different orders);
- the seg targets (``seg_targets``) and their valid mask: exact, read
  from ``jax.grad`` of the JAX loss on maps at the seg resolution (no
  resize), threshold and tie values included;
- ``seg_loss_from_cpg`` on live maps: the resized maps within atol 1e-6
  (``jax.image.resize`` contracts the two axes in another order), the loss
  within rtol 1e-5; every resized value lies more than 1e-5 (ten times
  the resize tolerance) from both thresholds, so the labels are the same;
- ``crf_constraint``: the refined probabilities within atol 2e-6 after
  two CRF iterations (``tests/test_torch_crf.py`` holds the default ten),
  the weights exact (every refined value lies more than 1e-5 from 0.5),
  ``crf_constraint_loss`` within rtol 1e-5;
- ``semantic_logits``: without the constraint as the head; with it (one
  CRF iteration), the CRF's inputs (probabilities within atol 1e-6, the
  resized raw image within atol 1e-3 on 0-255) and the refined
  probabilities within atol 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.config import CfgNode
from drn_wsod_torch.models.heads import seg as port_seg
from drn_wsod_tpu.models import build_model as jax_build_model
from drn_wsod_tpu.models.heads import seg as ref_seg
from test_modeling import tiny_batch, tiny_cfg
from test_torch_common import (load_prefixed, param_shapes, random_params,
                               unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def port_batch(jb) -> drn_wsod_torch.WSODBatch:
    """The JAX package's WSODBatch as the port's."""
    return drn_wsod_torch.WSODBatch(**{
        k: torch.from_numpy(np.array(getattr(jb, k)))
        for k in drn_wsod_torch.WSODBatch.__dataclass_fields__
        if getattr(jb, k, None) is not None})


def tiny_pair(head="WSJDSROIHeads", **sets):
    """(JAX cfg, port cfg): ``tiny_cfg(head)`` with ``sets`` (dotted keys
    with ``__``), the port's merged from the same tree."""
    jc = tiny_cfg(head)
    for k, v in sets.items():
        node = jc
        *path, leaf = k.split("__")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, v)
    pc = drn_wsod_torch.get_cfg()
    pc.merge_from_other(CfgNode(jc.to_dict()))
    pc.MODEL.WEIGHTS = jc.MODEL.WEIGHTS         # None: no merge from it
    assert pc.to_dict() == jc.to_dict()
    return jc, pc


def tiny_models(**sets):
    """(JAX model, flat flax params, port model, JAX cfg, port cfg)."""
    jc, pc = tiny_pair(**sets)
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    # the constraint adds no parameter: trace the init without the CRF
    flat = random_params(param_shapes(lambda: jm.clone(
        seg_constraint=False).init({"params": key, "dropout": key},
                                   tiny_batch(), train=True)), seed=1)
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    return jm, flat, pm, jc, pc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aspp_seg_head(dtype):
    x = np.random.RandomState(0).randn(2, 9, 11, 32).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    pdt = getattr(torch, dtype)
    jm = ref_seg.ASPPSegHead(num_classes=4, aspp_channels=16, dtype=jdt)
    pm = port_seg.ASPPSegHead(32, 4, aspp_channels=16, dtype=pdt)
    flat = random_params(param_shapes(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), 2)
    want = np.asarray(jm.apply({"params": unflatten(flat)},
                               jnp.asarray(x, jdt)))
    load_prefixed(pm, flat, "seg_head.", "seg_head.")
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(pdt))
    assert got.dtype == torch.float32 and got.shape == (2, 9, 11, 5)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


def _jax_targets(cpg_small, labels):
    """JAX's seg targets and valid mask, read from the gradient of its loss
    with respect to the logits: zero off the valid pixels, and negative
    only at the target class (softmax - one-hot)."""
    B, H, W, C = cpg_small.shape
    logits = jnp.zeros((B, H, W, C + 1))
    cpg = jnp.asarray(cpg_small.transpose(0, 3, 1, 2))
    g = np.asarray(jax.grad(lambda z: ref_seg.seg_loss_from_cpg(
        z, cpg, jnp.asarray(labels), None))(logits))
    valid = (g != 0).any(-1)
    return np.where(valid, g.argmin(-1), 0), valid


def test_seg_targets_exact():
    rs = np.random.RandomState(3)
    B, H, W, C = 3, 9, 10, 4
    cpg = rs.choice([0.0, 0.05, 0.0999, 0.1, 0.3, 0.4999, 0.5, 0.7, 1.0],
                    (B, H, W, C)).astype(np.float32)
    cpg[0, 0, :2, :] = 0.7                      # ties: the first class wins
    labels = (rs.rand(B, C) < 0.6).astype(np.float32)
    labels[2] = 0.0                             # no class present
    target, valid = port_seg.seg_targets(torch.from_numpy(cpg),
                                         torch.from_numpy(labels))
    want_t, want_v = _jax_targets(cpg, labels)
    np.testing.assert_array_equal(valid.numpy(), want_v)
    np.testing.assert_array_equal(target.numpy()[want_v], want_t[want_v])
    assert 0 < want_v.mean() < 1 and (want_t[want_v] > 0).any() \
        and (want_t[want_v] == 0).any()


def _live_cpg(B, C, H, W, seed):
    """(B, C, H, W) maps in [0, 1]: a Gaussian blob a class, max 1."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    cpg = np.zeros((B, C, H, W), np.float32)
    for b in range(B):
        for c in range(C):
            cy, cx, s = rs.uniform(0, H), rs.uniform(0, W), rs.uniform(4, 12)
            cpg[b, c] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                               / (2 * s * s))
    return cpg


def test_seg_loss_from_cpg_live_maps():
    B, C, H, W, h, w = 2, 4, 64, 60, 8, 7
    cpg = _live_cpg(B, C, H, W, seed=4)
    labels = np.array([[1, 1, 0, 0], [0, 1, 1, 1]], np.float32)
    logits = np.random.RandomState(5).randn(B, h, w, C + 1).astype(
        np.float32)
    small = np.asarray(jax.image.resize(jnp.asarray(cpg), (B, C, h, w),
                                        "linear"))
    for t in (0.1, 0.5):                        # labels decided alike
        assert np.abs(small - t).min() > 1e-5
    got_small = port_seg.resize_linear(torch.from_numpy(cpg), (B, C, h, w))
    np.testing.assert_allclose(got_small.numpy(), small, rtol=0, atol=1e-6)
    want = float(ref_seg.seg_loss_from_cpg(
        jnp.asarray(logits), jnp.asarray(cpg), jnp.asarray(labels), None))
    got = port_seg.seg_loss_from_cpg(torch.from_numpy(logits),
                                     torch.from_numpy(cpg),
                                     torch.from_numpy(labels))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    t, v = port_seg.seg_targets(got_small.permute(0, 2, 3, 1),
                                torch.from_numpy(labels))
    assert (t[v] > 0).any() and (t[v] == 0).any() and not v.all()


def test_crf_constraint_and_loss():
    rs = np.random.RandomState(6)
    B, h, w, C = 2, 12, 16, 3
    img = np.zeros((B, 48, 64, 3), np.float32)
    img[:, :, :32] = 200.0
    img[:, :, 32:] = 40.0
    img += rs.uniform(0, 20, img.shape).astype(np.float32)
    fg = np.full((B, h, w, C), 0.05, np.float32)
    fg[:, :, :8, 0] = 0.9
    fg[1, 3:9, 9:14, 2] = 0.8
    fg += rs.rand(B, h, w, C).astype(np.float32) * 0.05
    want_fg, want_w = ref_seg.crf_constraint(jnp.asarray(fg),
                                             jnp.asarray(img), max_iter=2)
    want_fg, want_w = np.asarray(want_fg), np.asarray(want_w)
    assert np.abs(want_fg - 0.5).min() > 1e-5   # thresholds decided alike
    got_fg, got_w = port_seg.crf_constraint(torch.from_numpy(fg),
                                            torch.from_numpy(img),
                                            max_iter=2)
    np.testing.assert_allclose(got_fg.numpy(), want_fg, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    assert 0 < (want_w > 0).mean() and (want_fg >= 0.5).any()
    want = float(ref_seg.crf_constraint_loss(
        jnp.asarray(fg), jnp.asarray(want_fg), jnp.asarray(want_w)))
    got = port_seg.crf_constraint_loss(torch.from_numpy(fg), got_fg, got_w)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_crf_constraint_loss_zeroes_terms_above_1000():
    """The reference's quirks: KL input log(sigmoid(p)) of the sigmoided
    prediction, terms above 1000 zeroed, a sum."""
    p = np.array([[0.2, 0.9, 0.5, 0.7]], np.float32)
    crf = np.array([[0.3, 0.8, 2000.0, 1e-14]], np.float32)
    w = np.array([[1.0, 0.5, 1.0, 2.0]], np.float32)
    want = float(ref_seg.crf_constraint_loss(*map(jnp.asarray, (p, crf, w))))
    got = port_seg.crf_constraint_loss(*map(torch.from_numpy, (p, crf, w)))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    assert np.isfinite(want)


@pytest.mark.parametrize("constraint", [False, True],
                         ids=["head", "crf_refined"])
def test_semantic_logits(constraint, monkeypatch):
    """Under the constraint both frameworks' ``crf_forward`` run one
    iteration here (ten take JAX 80 s to compile in its vmap; the default
    ten are held in ``tests/test_torch_crf.py``), and the inputs each
    meta-architecture hands the CRF are compared too: the softmax of the
    logits and the raw image resized to the head's resolution."""
    from drn_wsod_torch.models import meta_arch
    from drn_wsod_tpu.ops import crf as jax_crf

    seen = {}

    def one_iteration(fn, name=None):
        def run(probs, image, **kw):
            if name:
                seen[name] = (probs.numpy(), image.numpy())
            return fn(probs, image, **{**kw, "max_iter": 1})
        return run

    monkeypatch.setattr(jax_crf, "crf_forward",
                        one_iteration(jax_crf.crf_forward))
    monkeypatch.setattr(meta_arch, "crf_forward",
                        one_iteration(meta_arch.crf_forward, "port"))
    jm, flat, pm, _, _ = tiny_models(
        MODEL__SEM_SEG_HEAD__CONSTRAINT=constraint)
    jb = tiny_batch(seed=2)
    variables = {"params": unflatten(flat)}
    want = np.asarray(jm.apply(variables, jb, method="semantic_logits"))
    got = pm.semantic_logits(port_batch(jb)).numpy()
    assert got.shape == want.shape == (2, 7, 7, 5)
    assert np.isfinite(got).all()
    if not constraint:
        assert not seen
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())
        return
    # the CRF's inputs: the head's softmax and the resized raw image
    head = jm.clone(seg_constraint=False).apply(variables, jb,
                                                method="semantic_logits")
    probs, image = seen["port"]
    np.testing.assert_allclose(probs, np.asarray(jax.nn.softmax(head)),
                               rtol=0, atol=1e-6)
    for b in range(2):
        want_img = jax.image.resize(jb.image[b], (7, 7, 3), "linear")
        np.testing.assert_allclose(image[b], np.asarray(want_img), rtol=0,
                                   atol=1e-3)
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=0, atol=2e-6)
    assert got.min() >= np.log(np.float32(1e-8))
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, atol=1e-5)


def test_build_model_wsjds():
    jm, _, pm, jc, pc = tiny_models(MODEL__SEM_SEG_HEAD__CONSTRAINT=True)
    assert (pm.head_type, pm.with_seg, pm.seg_constraint) == \
        (jm.head_type, jm.with_seg, jm.seg_constraint) == ("CSC", True, True)
    assert not pm.use_pallas_pooler and not hasattr(pm, "box_refinery")
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in pm.seg_head.parameters())
