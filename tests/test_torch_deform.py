"""Deformable and grouped ResNet blocks against the JAX package, on the
CPU: ``ops/deform_conv.py:deform_conv2d`` (v1, modulated v2, dilation 2,
offsets that carry taps off the map), ``DeformBottleneckBlock`` in float32
and in bfloat16 (its offset conv in float32), the grouped 3x3 convs of the
WS and plain bottlenecks, and the builders' choices.

Weights are drawn at random, ``conv2_offset`` included: the YAML's zero
init would sample every tap at its integer position and leave the bilinear
weights untested. Tolerances: ``deform_conv2d`` within rtol 1e-5, atol 1e-5
of the largest |value| in float32 (the contraction's summation order
differs), and on bfloat16 maps within one bfloat16 ulp of the JAX value,
95 % of the values equal (the sampled taps round alike; the float32
contraction sums in another order, then rounds once); the blocks within rtol
1e-4, atol 1e-5 in float32, as the other towers, and the deformable block
under bfloat16 within 2 bfloat16 ulps of the largest |value| (three
bfloat16 convs and a float32 offset conv whose summation orders differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.models.backbones import resnet_ws as port
from drn_wsod_torch.ops.deform_conv import deform_conv2d
from drn_wsod_tpu.models.backbones import resnet_ws as ref
from drn_wsod_tpu.ops.deform_conv import deform_conv2d as jax_deform
from test_torch_common import (cfg_pair, load_prefixed, nhwc_to_port,
                               param_shapes, port_to_nhwc, random_params,
                               unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _deform_inputs(seed, H=9, W=11, Cin=5, Cout=7, K=3, scale=1.5):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, H, W, Cin).astype(np.float32)
    # offsets up to +-3 cells: taps land between cells and off the map
    off = (rng.randn(2, H, W, 2 * K * K) * scale).astype(np.float32)
    w = (rng.randn(K, K, Cin, Cout) / np.sqrt(K * K * Cin)).astype(np.float32)
    mod = rng.uniform(0, 1, (2, H, W, K * K)).astype(np.float32)
    return x, off, w, mod


def _jax_deform(x, off, w, mod, dilation, dtype):
    f = jax.vmap(lambda a, o, m: jax_deform(
        a, o, jnp.asarray(w, dtype), m, kernel_size=3, dilation=dilation))
    return np.asarray(f(jnp.asarray(x, dtype), jnp.asarray(off),
                        None if mod is None else jnp.asarray(mod))
                      .astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("dilation", [1, 2])
def test_deform_conv2d_matches(dilation, modulated, dtype):
    x, off, w, mod = _deform_inputs(dilation + 2 * modulated)
    mod = mod if modulated else None
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = _jax_deform(x, off, w, mod, dilation, jdt)
    got = deform_conv2d(
        torch.from_numpy(x).to(tdt), torch.from_numpy(off),
        torch.from_numpy(w.transpose(3, 2, 0, 1)).to(tdt),
        None if mod is None else torch.from_numpy(mod), dilation=dilation)
    assert got.dtype == tdt and got.shape == (2, 9, 11, 7)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    else:
        # the float32 sums differ in order; each rounds once to bfloat16
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()
        assert (got == want).mean() > 0.95


def test_deform_conv2d_zero_offsets_is_the_dilated_conv():
    """Zero offsets sample every tap at its cell: the op is the plain
    dilated 3x3 conv (SAME padding, zeros outside)."""
    x, _, w, _ = _deform_inputs(7)
    off = np.zeros((2, 9, 11, 18), np.float32)
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1))
    got = deform_conv2d(torch.from_numpy(x), torch.from_numpy(off), tw,
                        dilation=2)
    want = torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2), tw, padding=2, dilation=2)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-5, atol=1e-5)


def _check(jax_module, port_module, x, flax_prefix, port_prefix, seed=0,
           dtype=torch.float32):
    shapes = param_shapes(lambda: jax_module.init(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)))
    flat = random_params(shapes, seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_module.apply({"params": unflatten(flat)},
                            jnp.asarray(x, jdt))
    load_prefixed(port_module, flat, flax_prefix, port_prefix)
    with torch.no_grad():
        got = port_module(nhwc_to_port(x).to(dtype).contiguous(
            memory_format=torch.channels_last))
    return got, want, flat


@pytest.mark.parametrize("modulated", [False, True])
@pytest.mark.parametrize("in_ch,out_ch,dilation,pool", [
    (16, 32, 2, None), (32, 32, 1, 2)])
def test_deform_block_matches(in_ch, out_ch, dilation, pool, modulated):
    x = np.random.RandomState(2).randn(2, 11, 13, in_ch).astype(np.float32)
    kw = dict(dilation=dilation, has_pool=pool is not None,
              pool_stride=pool or 1, deform_modulated=modulated)
    jm = ref.DeformBottleneckBlock(out_ch, 8, **kw)
    pm = port.DeformBottleneckBlock(in_ch, out_ch, 8, **kw)
    got, want, flat = _check(jm, pm, x, "backbone.res4_0.",
                             "backbone.res4.0.")
    assert np.abs(flat["conv2_offset.kernel"]).min() > 0
    np.testing.assert_allclose(port_to_nhwc(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_deform_block_under_bfloat16():
    """bfloat16 block from float32 masters: ``conv2_offset`` computes in
    float32 on the upcast input (its output float32, the offsets exact to
    the JAX ones up to summation order), the deform weight is cast."""
    x = np.random.RandomState(3).randn(2, 11, 13, 16).astype(np.float32)
    jm = ref.DeformBottleneckBlock(32, 8, dilation=2, deform_modulated=True,
                                   dtype=jnp.bfloat16)
    pm = port.DeformBottleneckBlock(16, 32, 8, dilation=2,
                                    deform_modulated=True,
                                    dtype=torch.bfloat16)
    got, want, _ = _check(jm, pm, x, "backbone.res4_0.", "backbone.res4.0.",
                          dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert pm.conv2_offset.weight.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    tol = 2 * 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(port_to_nhwc(got.float()), want, rtol=0,
                               atol=tol)
    with torch.no_grad():
        h = torch.relu(pm.conv1(nhwc_to_port(x).bfloat16()))
        off, mod = pm.offsets(h)
    assert off.dtype == mod.dtype == torch.float32


def test_deform_block_with_zero_offsets_is_the_plain_bottleneck():
    """With ``conv2_offset`` zero (the reference's init), the modulated
    block is the plain bottleneck with its 3x3 output scaled by
    sigmoid(0) = 1/2 per tap; unmodulated it is the plain bottleneck."""
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 16, 9, 10)
                         .astype(np.float32))
    deform = port.DeformBottleneckBlock(16, 32, 8, dilation=2)
    plain = port.BottleneckBlock(16, 32, 8, dilation=2)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in deform.parameters():
            p.normal_(0, 0.3, generator=g)
        deform.conv2_offset.weight.zero_()
        deform.conv2_offset.bias.zero_()
        plain.load_state_dict({k: v for k, v in deform.state_dict().items()
                               if "conv2_offset" not in k})
        np.testing.assert_allclose(deform(x).numpy(), plain(x).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [2, 4])
def test_grouped_bottleneck_matches(groups):
    x = np.random.RandomState(5).randn(2, 10, 12, 16).astype(np.float32)
    jm = ref.BottleneckBlock(32, 16, dilation=2, num_groups=groups)
    pm = port.BottleneckBlock(16, 32, 16, dilation=2, num_groups=groups)
    assert pm.conv2.weight.shape == (16, 16 // groups, 3, 3)
    got, want, _ = _check(jm, pm, x, "backbone.res3_0.", "backbone.res3.0.")
    np.testing.assert_allclose(port_to_nhwc(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("builder", ["ws", "plain"])
def test_grouped_towers_match(builder):
    """A narrow ResNeXt-style R50 (NUM_GROUPS 4, WIDTH_PER_GROUP 2) in
    both towers: bottleneck widths num_groups * width_per_group."""
    jc, pc = cfg_pair("MODEL.RESNETS.DEPTH", 50,
                      "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
                      "MODEL.RESNETS.NUM_GROUPS", 4,
                      "MODEL.RESNETS.WIDTH_PER_GROUP", 2,
                      "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
                      "MODEL.DTYPE", "float32")
    build = {"ws": (ref.build_ws_resnet_backbone,
                    port.build_ws_resnet_backbone),
             "plain": (ref.build_resnet_backbone,
                       port.build_resnet_backbone)}[builder]
    jm = build[0](jc)[0]
    pm = build[1](pc)
    x = np.random.RandomState(6).uniform(-1, 1, (1, 48, 56, 3)).astype(
        np.float32)
    got, want, _ = _check(jm, pm, x, "backbone.", "backbone.")
    np.testing.assert_allclose(port_to_nhwc(got["res5"]),
                               np.asarray(want["res5"]), rtol=RTOL, atol=ATOL)


def test_builders_place_the_deformable_blocks():
    _, pc = cfg_pair("MODEL.RESNETS.DEPTH", 50,
                     "MODEL.RESNETS.DEFORM_ON_PER_STAGE",
                     [False, False, True, True],
                     "MODEL.RESNETS.DEFORM_MODULATED", True)
    ws = port.build_ws_resnet_backbone(pc)
    kinds = {s: {type(b).__name__ for b in getattr(ws, s)}
             for s in ws.stage_names}
    assert kinds == {"res2": {"BottleneckBlock"}, "res3": {"BottleneckBlock"},
                     "res4": {"DeformBottleneckBlock"},
                     "res5": {"DeformBottleneckBlock"}}
    assert ws.res4[0].conv2_offset.out_channels == 27
    # the plain ResNet ignores DEFORM_ON_PER_STAGE, as the JAX builder does
    plain = port.build_resnet_backbone(pc)
    assert not any(isinstance(m, port.DeformBottleneckBlock)
                   for m in plain.modules())
    _, grouped = cfg_pair("MODEL.RESNETS.DEPTH", 50,
                          "MODEL.RESNETS.NUM_GROUPS", 2,
                          "MODEL.RESNETS.DEFORM_ON_PER_STAGE",
                          [False, False, True, True])
    with pytest.raises(ValueError, match="NUM_GROUPS"):
        port.build_ws_resnet_backbone(grouped)
