"""The port's WS-ResNet against the JAX package's, same weights and inputs.

Tolerance (float32): rtol 1e-4, atol 1e-5 — the two sides differ only in
the convolutions' summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.models.backbones import resnet_ws as port
from drn_wsod_tpu.models.backbones import resnet_ws as ref
from test_torch_common import (load_prefixed, nhwc_to_port, param_shapes,
                               port_to_nhwc, random_params, unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _check(jax_module, port_module, x, flax_prefix, port_prefix, seed=0):
    shapes = param_shapes(lambda: jax_module.init(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)))
    flat = random_params(shapes, seed)
    want = jax_module.apply({"params": unflatten(flat)}, jnp.asarray(x))
    load_prefixed(port_module, flat, flax_prefix, port_prefix)
    with torch.no_grad():
        got = port_module(nhwc_to_port(x).contiguous(
            memory_format=torch.channels_last))
    return got, want


@pytest.mark.parametrize("in_ch,out_ch,dilation,pool", [
    (16, 16, 1, None), (16, 32, 1, 2), (32, 32, 2, 1)])
def test_basic_block(in_ch, out_ch, dilation, pool):
    x = np.random.RandomState(0).randn(2, 12, 12, in_ch).astype(np.float32)
    jm = ref.BasicBlock(out_ch, dilation=dilation, has_pool=pool is not None,
                        pool_stride=pool or 1)
    pm = port.BasicBlock(in_ch, out_ch, dilation=dilation,
                         has_pool=pool is not None, pool_stride=pool or 1)
    got, want = _check(jm, pm, x, "backbone.res2_0.", "backbone.res2.0.")
    np.testing.assert_allclose(port_to_nhwc(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("in_ch,out_ch,bc,dilation,pool", [
    (16, 32, 8, 2, None), (32, 32, 8, 2, 1), (16, 32, 8, 1, 2)])
def test_bottleneck_block(in_ch, out_ch, bc, dilation, pool):
    x = np.random.RandomState(1).randn(2, 11, 13, in_ch).astype(np.float32)
    jm = ref.BottleneckBlock(out_ch, bc, dilation=dilation,
                             has_pool=pool is not None, pool_stride=pool or 1)
    pm = port.BottleneckBlock(in_ch, out_ch, bc, dilation=dilation,
                              has_pool=pool is not None, pool_stride=pool or 1)
    got, want = _check(jm, pm, x, "backbone.res4_0.", "backbone.res4.0.")
    np.testing.assert_allclose(port_to_nhwc(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_stem():
    x = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    got, want = _check(ref.BasicStem(16), port.BasicStem(16), x,
                       "backbone.stem.", "backbone.stem.")
    assert got.shape == (2, 16, 8, 8)
    np.testing.assert_allclose(port_to_nhwc(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kwargs", [
    dict(depth=18, stem_out_channels=16, width_per_group=16,
         res2_out_channels=64),
    dict(depth=50, stem_out_channels=16, width_per_group=8,
         res2_out_channels=32),
], ids=["r18", "narrow_r50"])
def test_tower_res5(kwargs):
    """Whole DC5 tower at 64 px: res5 is 7x7, not 8x8 — res3's trailing
    2x2 pool has stride 1 and VALID padding."""
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    jm = ref.ResNetWS(res5_dilation=2, **kwargs)
    pm = port.ResNetWS(res5_dilation=2, **kwargs)
    got, want = _check(jm, pm, x, "backbone.", "backbone.")
    res5 = port_to_nhwc(got["res5"])
    assert res5.shape == (2, 7, 7, pm.feature_channels["res5"])
    assert pm.feature_strides == jm.feature_strides
    assert pm.feature_channels == jm.feature_channels
    np.testing.assert_allclose(res5, np.asarray(want["res5"]),
                               rtol=RTOL, atol=ATOL)


def test_stage_specs_match():
    for depth, dil in ((18, 2), (50, 2), (50, 1), (101, 2)):
        assert port.stage_specs(depth, dil, 256, 64) == \
            ref.ResNetWS.stage_specs(depth, dil, 256, 64)
