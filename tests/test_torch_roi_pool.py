"""The port's exact RoIPool (plain version) against the JAX package: its
kernel's exact XLA twin ``_xla_fallback`` and ``roi_align.roi_pool``.
Exact: max |diff| == 0 in bfloat16 and float32, compared by value (an empty
bin may be -0.0 on one side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.ops import roi_pool as port_pool
from drn_wsod_tpu.ops.roi_align import _rmq_bounds
from drn_wsod_tpu.ops.roi_align import roi_pool as jax_roi_pool
from drn_wsod_tpu.ops.roi_pool_pallas import _xla_fallback

torch.set_num_threads(1)

_xla_fallback = jax.jit(_xla_fallback, static_argnums=(2, 3))
_rmq_bounds = jax.jit(_rmq_bounds, static_argnums=(2, 3, 4))

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

# every tier of the Pallas kernel (tests/test_roi_pool_pallas.py:90), at
# H = W = 64, scale 1/4
TIER_BOXES = [
    [4.0, 4.0, 24.0, 24.0], [9.0, 3.0, 40.0, 90.0], [8.0, 8.0, 100.0, 100.0],
    [8.0, 8.0, 100.0, 36.0], [2.0, 40.0, 162.0, 62.0], [0.0, 0.0, 255.0, 255.0],
    [5.0, 0.0, 165.0, 60.0], [120.0, 120.0, 126.0, 126.0],
    [-20.0, -20.0, 300.0, 300.0], [30.0, 30.0, 90.0, 140.0],
    [40.0, 100.0, 150.0, 128.0], [200.0, 8.0, 230.0, 100.0],
]


def _case(name, rng, B=2, H=16, W=16, P=24):
    """(H, W, scale, boxes (B, P, 4)) for one geometry case."""
    if name == "tiers":
        boxes = np.array(TIER_BOXES, np.float32)
        return 64, 64, 0.25, np.stack([boxes, boxes[::-1].copy()])
    if name == "off_map":
        # partly off each edge, fully off every side, far-off context
        x1 = rng.uniform(-80, W * 8 + 40, (B, P))
        y1 = rng.uniform(-80, H * 8 + 40, (B, P))
        bw = rng.uniform(1, W * 10, (B, P))
        bh = rng.uniform(1, H * 10, (B, P))
        boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
        boxes[:, 0] = [-400, -400, -300, -300]        # fully above-left
        boxes[:, 1] = [W * 8 + 50, 0, W * 8 + 90, 40]  # fully right
        boxes[:, 2] = [-1000, -1000, 5000, 5000]      # whole map and beyond
        return H, W, 0.125, boxes.astype(np.float32)
    if name == "inverted":
        # x2 < x1 and/or y2 < y1: roi size clamps to 1 cell
        x1 = rng.uniform(0, W * 8, (B, P))
        y1 = rng.uniform(0, H * 8, (B, P))
        dx = rng.uniform(-60, 20, (B, P))
        dy = rng.uniform(-60, 20, (B, P))
        return H, W, 0.125, np.stack([x1, y1, x1 + dx, y1 + dy],
                                     -1).astype(np.float32)
    if name == "half_cells":
        # coordinates at k + 0.5 map cells: round half to even
        k = rng.randint(-3, max(H, W) + 3, (B, P, 4)).astype(np.float32)
        return H, W, 0.125, (8.0 * (k + 0.5)).astype(np.float32)
    assert name == "random"
    # the synthetic-batch distribution at a DC5-like stride of 8
    x1 = rng.uniform(0, W * 8 * 0.6, (B, P))
    y1 = rng.uniform(0, H * 8 * 0.6, (B, P))
    bw = rng.uniform(8, W * 8 * 0.4, (B, P))
    bh = rng.uniform(8, H * 8 * 0.4, (B, P))
    return H, W, 0.125, np.stack([x1, y1, x1 + bw, y1 + bh],
                                 -1).astype(np.float32)


CASES = ["tiers", "off_map", "inverted", "half_cells", "random"]


def _inputs(case, seed):
    rng = np.random.RandomState(seed)
    H, W, scale, boxes = _case(case, rng)
    B, P = boxes.shape[:2]
    feat = rng.randn(B, H, W, 8).astype(np.float32)
    obj = rng.uniform(0, 1, (B, P)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, P)) > 0.25              # invalid slots
    roi_scale = ((obj + 1.0) * mask).astype(np.float32)
    return feat, boxes, scale, roi_scale


def _assert_equal_by_value(got: torch.Tensor, want) -> None:
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got - want).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_xla_fallback(case, dtype):
    """Batched plain version + fused roi_scale == the kernel's XLA twin."""
    tdt, jdt = DTYPES[dtype]
    feat, boxes, scale, roi_scale = _inputs(case, seed=CASES.index(case))
    want = _xla_fallback(jnp.asarray(feat, jdt), jnp.asarray(boxes), scale,
                         7, jnp.asarray(roi_scale))
    got = port_pool.roi_pool_batched(
        torch.from_numpy(feat).to(tdt), torch.from_numpy(boxes), scale, 7,
        torch.from_numpy(roi_scale))
    assert got.dtype == tdt
    _assert_equal_by_value(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_single_image_matches_roi_pool(case, dtype):
    """Unscaled single-image pool == ops/roi_align.py:roi_pool."""
    tdt, jdt = DTYPES[dtype]
    feat, boxes, scale, _ = _inputs(case, seed=10 + CASES.index(case))
    want = jax_roi_pool(jnp.asarray(feat[0], jdt), jnp.asarray(boxes[0]),
                        scale, resolution=7)
    got = port_pool.roi_pool(torch.from_numpy(feat[0]).to(tdt),
                             torch.from_numpy(boxes[0]), scale, 7)
    _assert_equal_by_value(got, want)


@pytest.mark.parametrize("case", CASES)
def test_bin_edges_match_rmq_bounds(case):
    """Integer bin edges, validity and the range-max window pair equal
    _rmq_bounds (negative starts and clamping included)."""
    feat, boxes, scale, _ = _inputs(case, seed=20 + CASES.index(case))
    H, W = feat.shape[1:3]
    b = torch.from_numpy(boxes[0])
    x1, y1, rw, rh = port_pool.map_coords(b, scale)
    sc = np.round(boxes[0] * np.float32(scale)).astype(np.int32)
    np.testing.assert_array_equal(x1.numpy(), sc[:, 0])
    np.testing.assert_array_equal(y1.numpy(), sc[:, 1])
    for start, size, n in ((x1, rw, W), (y1, rh, H)):
        levels = port_pool._num_levels(n, 7)
        lo, hi = port_pool.bin_edges(start, size, n, 7)
        want = _rmq_bounds(jnp.asarray(start.numpy(), jnp.int32),
                           jnp.asarray(size.numpy(), jnp.int32), n, 7, levels)
        lo2, pos2, level = port_pool._rmq(lo, hi, levels)
        for got, w in zip((lo2, pos2, level, hi > lo), want):
            np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_cpu_call_does_not_count_a_launch():
    feat, boxes, scale, roi_scale = _inputs("random", seed=0)
    before = port_pool.roi_pool_batched.launches
    port_pool.roi_pool_batched(torch.from_numpy(feat), torch.from_numpy(boxes),
                               scale, 7, torch.from_numpy(roi_scale))
    assert port_pool.roi_pool_batched.launches == before == 0


@pytest.mark.slow
def test_plain_matches_pallas_grid_interpret():
    """Against the Pallas kernel itself in interpret mode (about 33 s on a
    CPU at this size, hence slow)."""
    from drn_wsod_tpu.ops.roi_pool_pallas import roi_pool_pallas_grid

    rng = np.random.RandomState(0)
    B, H, W, C, P = 2, 12, 12, 8, 8
    feat = rng.randn(B, H, W, C).astype(np.float32)
    x1 = rng.uniform(-8, W * 8, (B, P)).astype(np.float32)
    y1 = rng.uniform(-8, H * 8, (B, P)).astype(np.float32)
    bw = rng.uniform(4, 90, (B, P)).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bw], -1)
    roi_scale = rng.uniform(1, 2, (B, P)).astype(np.float32)
    roi_scale[:, -2:] = 0.0
    want = roi_pool_pallas_grid(
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(boxes), 0.125,
        resolution=7, roi_block=4, c_tile=8, interpret=True,
        roi_scale=jnp.asarray(roi_scale))
    got = port_pool.roi_pool_batched(
        torch.from_numpy(feat).to(torch.bfloat16), torch.from_numpy(boxes),
        0.125, 7, torch.from_numpy(roi_scale))
    _assert_equal_by_value(got, want)
