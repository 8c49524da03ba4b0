"""Rotated RoIAlign against the jitted JAX ``roi_align_rotated``, on the
CPU: RoIs at angles 0, +-30, 90 and 180 (each jittered by a few degrees
but the exact ones), sampling ratios 1-3, one chunk and several.

Torch's ``cos`` and ``sin`` differ from XLA's by an ulp on some angles,
and XLA orders and contracts the sample points' arithmetic its own way,
so a sample point can move by an ulp: in float32 the pools agree within
2e-5 on a map of standard normal values. In bfloat16 (the sum still in
float32, cast once) at most one bf16 ulp apart, on at most 0.1% of the
values. At angle 0 the pool is the axis-aligned ROIAlignV2 of the same
box (``ops/roi_align.py:roi_align`` with ``aligned``), within 2e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.ops.roi_align import roi_align
from drn_wsod_torch.ops.roi_align_rotated import roi_align_rotated
from drn_wsod_tpu.ops.roi_align_rotated import \
    roi_align_rotated as jax_roi_align_rotated

torch.set_num_threads(1)

ATOL = 2e-5
ANGLES = (0.0, 30.0, -30.0, 90.0, 180.0)
SCALE = 0.25


def _rois(rs, n, H, W, angles=ANGLES, jitter=True):
    a = np.asarray(angles)[rs.randint(0, len(angles), n)]
    if jitter:
        a = a + np.where(rs.uniform(size=n) < 0.5, 0.0,
                         rs.uniform(-8, 8, n))
    return np.stack([rs.uniform(-8, W / SCALE + 8, n),
                     rs.uniform(-8, H / SCALE + 8, n),
                     rs.uniform(2, 70, n), rs.uniform(2, 70, n), a],
                    -1).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    feat = rs.randn(24, 20, 8).astype(np.float32)
    return feat, _rois(rs, 40, 24, 20)


@pytest.mark.parametrize("ratio", [1, 2, 3])
@pytest.mark.parametrize("chunk", [16, 512])
def test_float32_matches_jax(inputs, ratio, chunk):
    feat, rois = inputs
    want = np.asarray(jax_roi_align_rotated(jnp.asarray(feat),
                                            jnp.asarray(rois), SCALE, 7,
                                            ratio, chunk=chunk))
    got = roi_align_rotated(torch.from_numpy(feat), torch.from_numpy(rois),
                            SCALE, 7, ratio, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (40, 7, 7, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert (want != 0).mean() > 0.5


@pytest.mark.parametrize("ratio", [1, 2, 3])
def test_bfloat16_within_one_ulp(inputs, ratio):
    feat, rois = inputs
    want = np.asarray(jax_roi_align_rotated(
        jnp.asarray(feat).astype(jnp.bfloat16), jnp.asarray(rois), SCALE, 7,
        ratio, chunk=16)).astype(np.float32)
    got = roi_align_rotated(torch.from_numpy(feat).bfloat16(),
                            torch.from_numpy(rois), SCALE, 7, ratio,
                            chunk=16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # one bf16 ulp: 2 ** (exponent - 7)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    diff = np.abs(got - want)
    assert (diff <= ulp).all(), (diff / ulp).max()
    assert (diff > 0).mean() <= 1e-3


def test_chunks_change_nothing(inputs):
    feat, rois = inputs
    f, r = torch.from_numpy(feat), torch.from_numpy(rois)
    whole = roi_align_rotated(f, r, SCALE, 7, 2, chunk=512)
    for chunk in (1, 7, 40):
        assert torch.equal(roi_align_rotated(f, r, SCALE, 7, 2, chunk=chunk),
                           whole)
    assert roi_align_rotated(f, r[:0], SCALE, 7, 2).shape == (0, 7, 7, 8)


@pytest.mark.parametrize("ratio", [1, 2, 3])
def test_angle_zero_is_aligned_roi_align(inputs, ratio):
    feat = torch.from_numpy(inputs[0])
    rois = torch.from_numpy(_rois(np.random.RandomState(ratio), 30, 24, 20,
                                  angles=(0.0,), jitter=False))
    cx, cy, w, h, _ = rois.unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    want = roi_align(feat, xyxy, SCALE, 7, ratio, aligned=True)
    got = roi_align_rotated(feat, rois, SCALE, 7, ratio)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)
