"""The port's VGG-16 and plain (strided) ResNet against the JAX package's,
same weights through ``params_from_jax`` and the same inputs, on the CPU.

Tolerances:
- float32: rtol 1e-4, atol 1e-5 times the largest value compared (the two
  sides differ only in the convolutions' summation order);
- bfloat16 VGG tower: each output within one bfloat16 ulp of the largest
  value compared, and at least 70% of them bit-equal (13 convs, each
  rounded to bfloat16, so a one-ulp difference in one layer moves its
  successors; measured: half an ulp, 81%, against one ulp and 74% with the
  bias fused into the product);
- one conv with bias in bfloat16: at least 99.9% bit-equal. Flax rounds
  the product, then adds the bfloat16 bias and rounds again; a bias fused
  into the product rounds once, which the test shows to be further off.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from drn_wsod_torch.models.backbones import resnet_ws as port_resnet
from drn_wsod_torch.models.backbones import vgg as port_vgg
from drn_wsod_torch.models.layers import Conv2d
from drn_wsod_tpu.models.backbones import resnet_ws as ref_resnet
from drn_wsod_tpu.models.backbones import vgg as ref_vgg
from test_torch_common import (load_prefixed, nhwc_to_port, param_shapes,
                               port_to_nhwc, random_params, unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _run(jax_module, port_module, x, flax_prefix, port_prefix,
         dtype=torch.float32, seed=0):
    """Both modules on NHWC numpy ``x`` with the same random weights;
    returns (port output, JAX output)."""
    shapes = param_shapes(lambda: jax_module.init(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)))
    flat = random_params(shapes, seed)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else None)
    want = jax_module.apply({"params": unflatten(flat)}, jx)
    load_prefixed(port_module, flat, flax_prefix, port_prefix)
    with torch.no_grad():
        got = port_module(nhwc_to_port(x).to(dtype).contiguous(
            memory_format=torch.channels_last))
    return got, want


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = port_to_nhwc(got.float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * np.abs(want).max())


@pytest.mark.parametrize("in_ch,out_ch,num_conv,dilation,pool,stride", [
    (8, 16, 2, 1, True, 2), (16, 16, 3, 1, True, 1),
    (16, 32, 3, 2, False, 2)], ids=["pool_s2", "pool_s1", "dilated"])
def test_plain_block(in_ch, out_ch, num_conv, dilation, pool, stride):
    x = np.random.RandomState(0).randn(2, 13, 12, in_ch).astype(np.float32)
    jm = ref_vgg.PlainBlock(out_ch, num_conv, dilation=dilation,
                            has_pool=pool, pool_stride=stride)
    pm = port_vgg.PlainBlock(in_ch, out_ch, num_conv, dilation=dilation,
                             has_pool=pool, pool_stride=stride)
    got, want = _run(jm, pm, x, "backbone.plain2.", "backbone.plain2.0.")
    _close(got, want)
    side = (13, 12) if not pool else ((6, 6) if stride == 2 else (12, 11))
    assert tuple(got.shape[2:]) == side


def test_bf16_bias_rounds_twice_as_flax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 16, 16, 32).astype(np.float32)
    jm = nn.Conv(64, (3, 3), padding=[(1, 1)] * 2, dtype=jnp.bfloat16)
    shapes = param_shapes(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    flat = random_params(shapes, 3)
    flat["bias"] = (rs.randn(64) * 0.5).astype(np.float32)
    want = np.asarray(jm.apply({"params": unflatten(flat)},
                               jnp.asarray(x, jnp.bfloat16)), np.float32)
    pm = Conv2d(32, 64, 3)
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(flat["kernel"]).permute(3, 2, 0, 1))
        pm.bias.copy_(torch.from_numpy(flat["bias"]))
        xt = nhwc_to_port(x).to(torch.bfloat16)
        got = port_to_nhwc(pm(xt).float())
        fused = port_to_nhwc(F.conv2d(
            xt, pm.weight.to(torch.bfloat16), pm.bias.to(torch.bfloat16),
            padding=1).float())
    same = (got == want).mean()
    assert same > 0.999, same
    assert (fused == want).mean() < same


def _vgg_pair(dilation=2):
    return (ref_vgg.VGG16(conv5_dilation=dilation,
                          out_features=("plain3", "plain5")),
            port_vgg.VGG16(conv5_dilation=dilation,
                           out_features=("plain3", "plain5")))


@pytest.mark.parametrize("dilation", [2, 1])
def test_vgg16_tower_float32(dilation):
    """The whole tower at 64 px: plain3 at 8x8; plain4's stride-1 pool
    leaves plain5 at 7x7 under dilation 2, its stride-2 pool 4x4 else."""
    x = np.random.RandomState(3).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jm, pm = _vgg_pair(dilation)
    got, want = _run(jm, pm, x, "backbone.", "backbone.")
    assert tuple(got["plain5"].shape) == ((2, 512, 7, 7) if dilation == 2
                                          else (2, 512, 4, 4))
    for k in ("plain3", "plain5"):
        _close(got[k], want[k])


def test_vgg16_tower_bfloat16():
    x = np.random.RandomState(4).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    jm = ref_vgg.VGG16(out_features=("plain5",), dtype=jnp.bfloat16)
    pm = port_vgg.VGG16(out_features=("plain5",)).to(torch.bfloat16)
    got, want = _run(jm, pm, x, "backbone.", "backbone.",
                     dtype=torch.bfloat16)
    got = port_to_nhwc(got["plain5"].float())
    want = np.asarray(want["plain5"], np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp
    assert (got == want).mean() >= 0.7


def test_plain_stem():
    x = np.random.RandomState(2).randn(2, 33, 30, 3).astype(np.float32)
    got, want = _run(ref_resnet.PlainStem(16), port_resnet.PlainStem(16), x,
                     "backbone.stem.", "backbone.stem.")
    assert tuple(got.shape) == (2, 16, 9, 8)
    _close(got, want)


@pytest.mark.parametrize("in_ch,out_ch,stride,dilation", [
    (16, 32, 2, 1), (32, 32, 1, 2), (16, 16, 2, 1)])
def test_basic_block_stride(in_ch, out_ch, stride, dilation):
    x = np.random.RandomState(5).randn(2, 11, 12, in_ch).astype(np.float32)
    jm = ref_resnet.BasicBlock(out_ch, dilation=dilation, stride=stride)
    pm = port_resnet.BasicBlock(in_ch, out_ch, dilation=dilation,
                                stride=stride)
    assert (pm.shortcut is None) == (in_ch == out_ch and stride == 1)
    got, want = _run(jm, pm, x, "backbone.res3_0.", "backbone.res3.0.")
    _close(got, want)


@pytest.mark.parametrize("stride_in_1x1", [True, False])
@pytest.mark.parametrize("stride,dilation", [(2, 1), (1, 2)])
def test_bottleneck_block_stride(stride_in_1x1, stride, dilation):
    x = np.random.RandomState(6).randn(2, 11, 12, 16).astype(np.float32)
    jm = ref_resnet.BottleneckBlock(32, 8, dilation=dilation, stride=stride,
                                    stride_in_1x1=stride_in_1x1)
    pm = port_resnet.BottleneckBlock(16, 32, 8, dilation=dilation,
                                     stride=stride,
                                     stride_in_1x1=stride_in_1x1)
    got, want = _run(jm, pm, x, "backbone.res4_0.", "backbone.res4.0.")
    _close(got, want)


PLAIN = {
    "r18": dict(depth=18, stem_out_channels=16, width_per_group=16,
                res2_out_channels=64),
    "narrow_r50": dict(depth=50, stem_out_channels=16, width_per_group=8,
                       res2_out_channels=32),
}


@pytest.mark.parametrize("stride_in_1x1", [True, False],
                         ids=["stride_in_1x1", "stride_in_3x3"])
@pytest.mark.parametrize("dilation", [2, 1], ids=["dc5", "c5"])
@pytest.mark.parametrize("arch", sorted(PLAIN))
def test_resnet_plain_tower(arch, dilation, stride_in_1x1):
    """The whole plain tower at 64 px: res5 at stride 16 (4x4) under DC5,
    at stride 32 (2x2) without it."""
    x = np.random.RandomState(7).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    kw = dict(PLAIN[arch], res5_dilation=dilation,
              stride_in_1x1=stride_in_1x1, out_features=("res4", "res5"))
    jm, pm = ref_resnet.ResNetPlain(**kw), port_resnet.ResNetPlain(**kw)
    got, want = _run(jm, pm, x, "backbone.", "backbone.")
    side = 4 if dilation == 2 else 2
    assert tuple(got["res5"].shape[1:]) == (pm.feature_channels["res5"],
                                            side, side)
    for k in ("res4", "res5"):
        _close(got[k], want[k])


@pytest.mark.parametrize("dilation", [2, 1])
def test_feature_strides_and_channels_match(dilation):
    jv, pv = ref_vgg.VGG16(conv5_dilation=dilation), \
        port_vgg.VGG16(conv5_dilation=dilation)
    assert pv.feature_strides == jv.feature_strides
    assert pv.feature_channels == jv.feature_channels
    for depth, res2 in ((18, 64), (50, 256), (101, 256)):
        kw = dict(depth=depth, res2_out_channels=res2, res5_dilation=dilation)
        jr = ref_resnet.ResNetPlain(**kw)
        pr = port_resnet.ResNetPlain(**kw)
        assert pr.feature_strides == jr.feature_strides
        assert pr.feature_channels == jr.feature_channels
    assert pr.feature_strides["res5"] == (16 if dilation == 2 else 32)
    assert pv.feature_strides["plain5"] == (8 if dilation == 2 else 16)
