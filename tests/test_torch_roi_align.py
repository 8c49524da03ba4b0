"""The port's differentiable exact RoIPool (``drn_wsod_torch/ops/
roi_align.py:roi_pool``) against the JAX package's
``ops/roi_align.py:roi_pool``, on the CPU.

Forward: bit-equal by value (max |diff| == 0) in float32 and bfloat16, on
the geometry cases of ``tests/test_torch_roi_pool.py`` and across the
512-RoI chunk boundary. Gradient w.r.t. the map: the same seeded cotangent
through both, against ``jax.grad`` in float32 within atol 1e-6 times the
gradient's largest magnitude (a cell's gradient sums the cotangents of
every bin that picks it, up to ~11 here, and the two scatter-adds sum in
different orders: the largest difference seen is 3.8e-6 at a value near
11, 3 ulps), including a constant map (every window ties: each ``maximum``
sends half its gradient each way) and duplicated boxes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.ops import roi_align as port_align
from drn_wsod_torch.ops import roi_pool as port_pool
from drn_wsod_tpu.ops.roi_align import roi_pool as jax_roi_pool
from test_torch_roi_pool import CASES, DTYPES, _case

torch.set_num_threads(1)

ATOL = 1e-6


def _inputs(case, seed, C=8):
    rng = np.random.RandomState(seed)
    if case == "constant":
        H, W, scale, boxes = _case("random", rng)
        feat = np.full((H, W, C), 0.5, np.float32)
        return feat, boxes[0], scale, rng
    if case == "duplicates":
        H, W, scale, boxes = _case("random", rng)
        boxes = boxes[0].copy()
        boxes[1::2] = boxes[0::2]                     # every box twice
        boxes[-4:] = boxes[0]
        # integer-valued features: many equal maxima between windows
        feat = rng.randint(0, 3, (H, W, C)).astype(np.float32)
        return feat, boxes, scale, rng
    if case == "chunks":
        # P = 600 crosses the 512-RoI chunk
        H, W = 20, 24
        x1 = rng.uniform(-16, W * 8, 600)
        y1 = rng.uniform(-16, H * 8, 600)
        boxes = np.stack([x1, y1, x1 + rng.uniform(1, 120, 600),
                          y1 + rng.uniform(1, 120, 600)], -1)
        feat = rng.randn(H, W, C).astype(np.float32)
        return feat, boxes.astype(np.float32), 0.125, rng
    H, W, scale, boxes = _case(case, rng)
    feat = rng.randn(H, W, C).astype(np.float32)
    return feat, boxes[0], scale, rng


GRAD_CASES = CASES + ["constant", "duplicates", "chunks"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", GRAD_CASES)
def test_forward_bit_equal(case, dtype):
    tdt, jdt = DTYPES[dtype]
    feat, boxes, scale, _ = _inputs(case, seed=GRAD_CASES.index(case))
    want = jax_roi_pool(jnp.asarray(feat, jdt), jnp.asarray(boxes), scale,
                        resolution=7)
    got = port_align.roi_pool(torch.from_numpy(feat).to(tdt),
                              torch.from_numpy(boxes), scale, 7)
    assert got.dtype == tdt
    got, want = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got - want).max()


@pytest.mark.parametrize("case", GRAD_CASES)
def test_map_gradient_matches_jax_grad(case):
    feat, boxes, scale, rng = _inputs(case, seed=40 + GRAD_CASES.index(case))
    ct = rng.randn(boxes.shape[0], 7, 7, feat.shape[-1]).astype(np.float32)

    def jax_loss(f):
        return jnp.sum(jax_roi_pool(f, jnp.asarray(boxes), scale,
                                    resolution=7) * ct)

    want = np.asarray(jax.jit(jax.grad(jax_loss))(jnp.asarray(feat)))
    f = torch.from_numpy(feat).requires_grad_(True)
    (port_align.roi_pool(f, torch.from_numpy(boxes), scale, 7)
     * torch.from_numpy(ct)).sum().backward()
    got = f.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL * np.abs(want).max())


def test_constant_map_splits_ties_in_halves():
    """One RoI whose bins each span 3 cells: the two covering windows
    overlap, and every max ties; the gradient reaching each cell is the
    JAX package's halving split (a cell read by both windows of a bin gets
    more than a cell read by one)."""
    feat = np.ones((8, 8, 1), np.float32)
    boxes = np.array([[0.0, 0.0, 20.0, 20.0]], np.float32)   # 21 cells / 7

    def jax_loss(f):
        return jnp.sum(jax_roi_pool(f, jnp.asarray(boxes), 1.0, resolution=7))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(feat)))
    f = torch.from_numpy(feat).requires_grad_(True)
    port_align.roi_pool(f, torch.from_numpy(boxes), 1.0, 7).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0,
                               atol=ATOL * np.abs(want).max())
    assert len(np.unique(want)) > 2           # uneven shares, not 0 / 1


def test_same_forward_as_the_kernels_plain_version():
    """The shared helpers give the model's pool and K1's plain twin the
    same values (the twin then scales them)."""
    feat, boxes, scale, _ = _inputs("random", seed=7)
    f, b = torch.from_numpy(feat), torch.from_numpy(boxes)
    assert torch.equal(port_align.roi_pool(f, b, scale, 7),
                       port_pool.roi_pool(f, b, scale, 7))


def test_model_pool_rounds_the_scale_twice_in_bf16():
    """The model's differentiable arm multiplies by bf16(objectness + 1),
    then by bf16(mask), as ``drn_wsod_tpu/models/meta_arch.py:241-244``
    does: bit-equal to the JAX composition on a bf16 map. (K1 rounds
    bf16((objectness + 1) * mask) once; with a 0/1 mask the values are the
    same, which the last check shows.)"""
    from test_torch_common import TOY, cfg_pair

    import drn_wsod_torch

    _, pc = cfg_pair(*TOY, "MODEL.DTYPE", "bfloat16",
                     "MODEL.BACKBONE.FREEZE_AT", 2)
    model = drn_wsod_torch.build_model(pc, device="cpu")
    assert not model.use_pallas_pooler
    rng = np.random.RandomState(8)
    B, H, W, C, P = 2, 12, 14, 8, 40
    feat = rng.randn(B, H, W, C).astype(np.float32)
    x1, y1 = rng.uniform(-8, 100, (2, B, P))
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, 60, (B, P)),
                      y1 + rng.uniform(1, 60, (B, P))], -1).astype(np.float32)
    obj = rng.uniform(0, 1, (B, P)).astype(np.float32)
    mask = rng.uniform(size=(B, P)) > 0.2
    got = model.pool(torch.from_numpy(feat).to(torch.bfloat16),
                     *(torch.from_numpy(a) for a in (boxes, mask, obj)))
    jf = jnp.asarray(feat, jnp.bfloat16)
    pooled = jax.vmap(lambda f, b: jax_roi_pool(f, b, 0.125, resolution=7))(
        jf, jnp.asarray(boxes))
    want = pooled * jnp.asarray(obj + 1.0)[..., None, None, None].astype(
        jnp.bfloat16)
    want = want * jnp.asarray(mask)[..., None, None, None].astype(jnp.bfloat16)
    got = got.float().numpy()
    assert np.array_equal(got, np.asarray(want).astype(np.float32))
    once = port_pool.roi_pool_batched(
        torch.from_numpy(feat).to(torch.bfloat16), torch.from_numpy(boxes),
        0.125, 7, torch.from_numpy((obj + 1.0) * mask))
    assert np.array_equal(got, once.float().numpy())
