"""K2, the single-image RoIPool (``roi_pool_image``, float and int8 modes),
plain version against the JAX package on the CPU.

Float mode against the kernel's exact XLA twin ``_xla_fallback``; int8 mode
against the composition of the JAX package's own pieces: the quantization
expression of ``roi_pool_pallas.py:1100-1104``, ``roi_align.roi_pool`` over
the int8 values as float32, then ``(max * ch_scale) * roi_scale`` in float32
cast to the map's dtype. Exact: max |diff| == 0, compared by value (an
empty bin may be -0.0 on one side). The comparison with the Pallas kernel
in interpret mode is slow-marked (about 33 s on a CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.ops import roi_pool as port_pool
from drn_wsod_tpu.ops.roi_align import roi_pool as jax_roi_pool
from drn_wsod_tpu.ops.roi_pool_pallas import _xla_fallback
from test_torch_roi_pool import CASES, DTYPES, _inputs

torch.set_num_threads(1)

_xla_fallback = jax.jit(_xla_fallback, static_argnums=(2, 3))


@jax.jit
def _jax_quantize(features):
    """roi_pool_pallas.py:1100-1104, verbatim."""
    absmax = jnp.max(jnp.abs(features.astype(jnp.float32)), axis=(0, 1))
    ch_scale = (jnp.maximum(absmax, 1e-6) / 127.0)
    src = jnp.clip(jnp.round(features.astype(jnp.float32) / ch_scale),
                   -127, 127).astype(jnp.int8)
    return src, ch_scale


def _jax_int8_pool(features, boxes, scale, roi_scale):
    q, ch_scale = _jax_quantize(features)
    m = jax_roi_pool(q.astype(jnp.float32), boxes, scale, resolution=7)
    if roi_scale is None:
        roi_scale = jnp.ones(boxes.shape[:1], jnp.float32)
    return ((m * ch_scale) * roi_scale[:, None, None, None]).astype(
        features.dtype)


def _assert_equal_by_value(got: torch.Tensor, want) -> None:
    got = got.float().numpy()
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got - want).max()


def _image(case, seed):
    """One image of a geometry case, 16 channels (the int8 vector width)."""
    feat, boxes, scale, roi_scale = _inputs(case, seed)
    rng = np.random.RandomState(seed)
    feat = np.concatenate([feat, rng.randn(*feat.shape)], -1)
    feat[..., 3] *= 1e-8                       # a channel near the 1e-6 floor
    return feat[0].astype(np.float32), boxes[0], scale, roi_scale[0]


@pytest.mark.parametrize("with_scale", [True, False],
                         ids=["roi_scale", "no_scale"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_float_mode_matches_xla_fallback(case, dtype, with_scale):
    tdt, jdt = DTYPES[dtype]
    feat, boxes, scale, roi_scale = _image(case, 30 + CASES.index(case))
    rs = roi_scale if with_scale else None
    want = _xla_fallback(jnp.asarray(feat, jdt), jnp.asarray(boxes), scale, 7,
                         None if rs is None else jnp.asarray(rs))
    got = port_pool.roi_pool_image(
        torch.from_numpy(feat).to(tdt), torch.from_numpy(boxes), scale, 7,
        None if rs is None else torch.from_numpy(rs))
    assert got.dtype == tdt
    _assert_equal_by_value(got, want)


@pytest.mark.parametrize("with_scale", [True, False],
                         ids=["roi_scale", "no_scale"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_int8_mode_matches_jax_composition(case, dtype, with_scale):
    tdt, jdt = DTYPES[dtype]
    feat, boxes, scale, roi_scale = _image(case, 40 + CASES.index(case))
    rs = roi_scale if with_scale else None
    want = _jax_int8_pool(jnp.asarray(feat, jdt), jnp.asarray(boxes), scale,
                          None if rs is None else jnp.asarray(rs))
    got = port_pool.roi_pool_image(
        torch.from_numpy(feat).to(tdt), torch.from_numpy(boxes), scale, 7,
        None if rs is None else torch.from_numpy(rs), quantize_int8=True)
    assert got.dtype == tdt
    _assert_equal_by_value(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_quantize_matches_jax(dtype):
    """q exactly, ch_scale bit for bit (true float32 division, round half
    to even, the 1e-6 floor)."""
    tdt, jdt = DTYPES[dtype]
    feat, _, _, _ = _image("random", 50)
    # channel 0 on halves with absmax 127: ch_scale 1, every x.5 a tie
    feat[..., 0] = np.random.RandomState(51).randint(
        -254, 255, feat.shape[:2]) / 2
    feat[0, 0, 0] = 127.0
    q_want, s_want = _jax_quantize(jnp.asarray(feat, jdt))
    q, s = port_pool.int8_quantize(torch.from_numpy(feat).to(tdt))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_want))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_want))


@pytest.mark.parametrize("quantize_int8", [False, True], ids=["float", "int8"])
def test_looped_matches_per_image_and_batched(quantize_int8):
    """roi_pool_looped is one roi_pool_image per image, stacked; in float
    mode it equals the batched K1 (roi_pool_batched)."""
    feat, boxes, scale, roi_scale = _inputs("off_map", seed=60)
    feat = np.concatenate([feat, feat[..., ::-1]], -1).copy()
    f, b, s = (torch.from_numpy(x) for x in (feat, boxes, roi_scale))
    f = f.to(torch.bfloat16)
    got = port_pool.roi_pool_looped(f, b, scale, 7, s, quantize_int8)
    for i in range(f.shape[0]):
        assert torch.equal(got[i], port_pool.roi_pool_image(
            f[i], b[i], scale, 7, s[i], quantize_int8))
    if not quantize_int8:
        want = port_pool.roi_pool_batched(f, b, scale, 7, s)
        _assert_equal_by_value(got, want.float().numpy())


def test_cpu_call_does_not_count_a_launch():
    feat, boxes, scale, roi_scale = _image("random", 0)
    before = dict(port_pool.roi_pool_image.launches)
    for q in (False, True):
        port_pool.roi_pool_image(torch.from_numpy(feat),
                                 torch.from_numpy(boxes), scale, 7,
                                 torch.from_numpy(roi_scale), q)
    assert port_pool.roi_pool_image.launches == before
    assert set(before.values()) == {0}


@pytest.mark.slow
@pytest.mark.parametrize("quantize_int8", [False, True], ids=["float", "int8"])
def test_plain_matches_pallas_interpret(quantize_int8):
    """Against the Pallas kernel itself in interpret mode, at H = W = 24,
    C = 8, P = 8, one box partly and one fully off the map."""
    from drn_wsod_tpu.ops.roi_pool_pallas import roi_pool_pallas

    rng = np.random.RandomState(7)
    H = W = 24
    feat = rng.randn(H, W, 8).astype(np.float32)
    x1 = rng.uniform(0, W * 8 - 40, 8)
    y1 = rng.uniform(0, H * 8 - 40, 8)
    bw = rng.uniform(8, 120, 8)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bw], -1).astype(np.float32)
    boxes[0] = [W * 8 - 30, -20, W * 8 + 60, 50]          # partly off
    boxes[1] = [-300, -300, -200, -200]                   # fully off
    roi_scale = rng.uniform(1, 2, 8).astype(np.float32)
    want = roi_pool_pallas(
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(boxes), 0.125,
        resolution=7, interpret=True, roi_scale=jnp.asarray(roi_scale),
        quantize_int8=quantize_int8)
    got = port_pool.roi_pool_image(
        torch.from_numpy(feat).to(torch.bfloat16), torch.from_numpy(boxes),
        0.125, 7, torch.from_numpy(roi_scale), quantize_int8)
    _assert_equal_by_value(got, want)
