"""The pyramid path against the JAX package, on the CPU: RoIAlign
(``ops/roi_align.py:roi_align``), the level assignment and the
multi-level pooler (``ops/poolers.py``), the WS-ResNet's pyramid stage
specs, nearest upsampling and the FPN tower (``models/backbones/fpn.py``).

Tolerances: the level assignment, the stage specs, the strides and the
upsampling indices bit-equal; ``roi_align`` and ``multilevel_roi_pool``
within 1e-6 of the largest |value| in float32 (the port computes the
sample points as XLA compiles them, a reciprocal multiply and a fused
multiply-add, but XLA also fuses the corner products into the sums: the
values differ by one or two float32 ulps) and within one bfloat16 ulp of
the JAX value in bfloat16 (where each operation rounds to bfloat16 the two
agree bit for bit); the FPN tower within rtol 1e-4, atol 1e-5 in float32,
as the other towers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.models.backbones import fpn as port_fpn
from drn_wsod_torch.models.backbones import resnet_ws as port_resnet
from drn_wsod_torch.ops import poolers as port_poolers
from drn_wsod_torch.ops import roi_align as port_align
from drn_wsod_tpu.models.backbones import fpn as jax_fpn
from drn_wsod_tpu.models.backbones import resnet_ws as jax_resnet
from drn_wsod_tpu.ops import poolers as jax_poolers
from drn_wsod_tpu.ops.roi_align import roi_align as jax_roi_align
from test_torch_common import (cfg_pair, load_prefixed, nhwc_to_port,
                               param_shapes, port_to_nhwc, random_params,
                               unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (None, torch.bfloat16, jnp.bfloat16)}


def _boxes(rng, P, H, W, stride):
    """Boxes in image coordinates over an (H, W) map of ``stride``: some
    past every border, some tiny (below a cell), some degenerate."""
    h, w = H * stride, W * stride
    x1 = rng.uniform(-0.3 * w, w, P)
    y1 = rng.uniform(-0.3 * h, h, P)
    bw = np.exp(rng.uniform(np.log(0.5), np.log(1.2 * w), P))
    bh = np.exp(rng.uniform(np.log(0.5), np.log(1.2 * h), P))
    b = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    b[:4] = [[0, 0, w, h], [-5, -5, 2, 3], [w - 1, h - 1, w + 9, h + 9],
             [3, 3, 3, 3]]
    return b.astype(np.float32)


def _bf16_ulp(x):
    """bfloat16's ulp at |x|: 2^(exponent - 7)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


def _close(got: torch.Tensor, want, dtype: str):
    """float32: within 1e-6 of the largest |value|. bfloat16: within one
    ulp of the JAX value."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    else:
        tol = _bf16_ulp(want)
        assert (np.abs(got - want) <= tol).all(), \
            np.abs(got - want)[np.abs(got - want) > tol]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("ratio", [1, 2, 3])
def test_roi_align_matches(aligned, ratio, dtype):
    rng = np.random.RandomState(ratio + 3 * aligned)
    H, W, C, P, stride = 13, 17, 6, 530, 8          # P crosses the chunk
    feat = rng.randn(H, W, C).astype(np.float32)
    boxes = _boxes(rng, P, H, W, stride)
    _, tdt, jdt = DTYPES[dtype]
    want = jax_roi_align(jnp.asarray(feat, jdt), jnp.asarray(boxes),
                               1.0 / stride, resolution=7,
                               sampling_ratio=ratio, aligned=aligned)
    got = port_align.roi_align(torch.from_numpy(feat).to(tdt),
                               torch.from_numpy(boxes), 1.0 / stride, 7,
                               ratio, aligned=aligned)
    assert got.dtype == tdt and got.shape == (P, 7, 7, C)
    _close(got, want, dtype)


def test_roi_align_gradient_flows_to_the_map():
    rng = np.random.RandomState(0)
    feat = torch.from_numpy(rng.randn(9, 9, 4).astype(np.float32))
    feat.requires_grad_(True)
    boxes = torch.from_numpy(_boxes(rng, 20, 9, 9, 4))
    out = port_align.roi_align(feat, boxes, 0.25, 7, 2, aligned=True)
    cot = rng.randn(*out.shape).astype(np.float32)
    (g,) = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), feat)

    def f(x):
        return jnp.sum(jax_roi_align(
            x, jnp.asarray(boxes.numpy()), 0.25, resolution=7,
            sampling_ratio=2, aligned=True) * cot)
    want = np.asarray(jax.grad(f)(jnp.asarray(feat.detach().numpy())))
    np.testing.assert_allclose(g.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_assign_boxes_to_levels_bit_equal():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 4000, 40, 40, 16)
    # sides at the level boundaries: sqrt(area) = 224 * 2^k exactly
    edge = np.array([[0, 0, s, s] for s in (56, 112, 224, 448, 896)]
                    + [[0, 0, 0, 0], [5, 5, 4, 9]], np.float32)
    boxes = np.concatenate([boxes, edge])
    want = jax_poolers.assign_boxes_to_levels(jnp.asarray(boxes), 2, 5)
    got = port_poolers.assign_boxes_to_levels(torch.from_numpy(boxes), 2, 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) == {2, 3, 4, 5}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pooler_type", ["ROIAlignV2", "ROIAlign",
                                         "ROIPool"])
def test_multilevel_roi_pool_matches(pooler_type, dtype):
    rng = np.random.RandomState(2)
    strides = {"p2": 4, "p3": 8, "p4": 16, "p5": 32}
    sizes = {"p2": (33, 41), "p3": (16, 20), "p4": (8, 10), "p5": (4, 5)}
    C = 5
    feats = {n: rng.randn(*hw, C).astype(np.float32)
             for n, hw in sizes.items()}
    boxes = _boxes(rng, 300, 33, 41, 4)
    _, tdt, jdt = DTYPES[dtype]
    names = ["p2", "p3", "p4", "p5"]
    want = jax_poolers.multilevel_roi_pool(
        {n: jnp.asarray(v, jdt) for n, v in feats.items()}, strides,
        jnp.asarray(boxes), names, resolution=7, pooler_type=pooler_type,
        sampling_ratio=2)
    got = port_poolers.multilevel_roi_pool(
        {n: torch.from_numpy(v).to(tdt) for n, v in feats.items()}, strides,
        torch.from_numpy(boxes), names, 7, pooler_type, 2)
    assert got.dtype == tdt and got.shape == (300, 7, 7, C)
    _close(got, want, dtype)


def test_pyramid_stage_specs_and_strides():
    for depth in (18, 50, 101):
        assert port_resnet.stage_specs(depth, 1, 256, 64, pyramid=True) == \
            jax_resnet.ResNetWS.stage_specs(depth, 1, 256, 64, pyramid=True)
    jc, pc = cfg_pair("MODEL.BACKBONE.NAME", "build_resnet_fpn_backbone",
                      "MODEL.ROI_HEADS.IN_FEATURES", ["p2", "p3", "p4", "p5"])
    _, j_strides, j_channels = jax_fpn.build_resnet_fpn_backbone(jc)
    pm = port_fpn.build_resnet_fpn_backbone(pc)
    assert pm.feature_strides == j_strides == {"p2": 4, "p3": 8, "p4": 16,
                                               "p5": 32, "p6": 64}
    assert pm.feature_channels == j_channels
    bu = pm.bottom_up
    assert bu.feature_strides == {"res2": 4, "res3": 8, "res4": 16,
                                  "res5": 32}


@pytest.mark.parametrize("m,n", [(5, 11), (5, 10), (7, 13), (4, 8), (6, 6),
                                 (9, 4)])
def test_upsample_nearest_matches_jax_image_resize(m, n):
    x = np.arange(2 * 3 * m * m, dtype=np.float32).reshape(2, 3, m, m)
    want = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1),
                            (2, n, n + 1, 3), "nearest").transpose(0, 3, 1, 2)
    got = port_fpn.upsample_nearest(torch.from_numpy(x), n, n + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _fpn_pair(*overrides):
    jc, pc = cfg_pair("MODEL.BACKBONE.NAME", "build_resnet_fpn_backbone",
                      "MODEL.RESNETS.DEPTH", 50,
                      "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
                      "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
                      "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
                      "MODEL.FPN.OUT_CHANNELS", 16, "MODEL.DTYPE", "float32",
                      *overrides)
    jm, _, _ = jax_fpn.build_resnet_fpn_backbone(jc)
    return jm, port_fpn.build_resnet_fpn_backbone(pc)


@pytest.mark.parametrize("hw", [(64, 64), (75, 93)])
def test_fpn_tower_matches(hw):
    """Odd sizes: each pool floors, so the top-down path upsamples by
    factors other than 2."""
    jm, pm = _fpn_pair()
    x = np.random.RandomState(3).uniform(-1, 1, (2, *hw, 3)).astype(
        np.float32)
    flat = random_params(param_shapes(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x))), seed=4)
    want = jm.apply({"params": unflatten(flat)}, jnp.asarray(x))
    load_prefixed(pm, flat, "backbone.", "backbone.")
    with torch.no_grad():
        got = pm(nhwc_to_port(x).contiguous(memory_format=torch.channels_last))
    assert set(got) == set(want) == {"p2", "p3", "p4", "p5", "p6"}
    for k in want:
        assert got[k].shape[2:] == want[k].shape[1:3], k
        np.testing.assert_allclose(port_to_nhwc(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_fpn_ignores_dilation_norm_and_deform():
    """The FPN builds its bottom-up tower without ``RES5_DILATION``,
    ``NORM`` or the deformable settings, as the JAX package's builder."""
    _, pm = _fpn_pair("MODEL.RESNETS.RES5_DILATION", 2,
                      "MODEL.RESNETS.NORM", "BN",
                      "MODEL.RESNETS.DEFORM_ON_PER_STAGE",
                      [False, False, True, True])
    mods = list(pm.bottom_up.modules())
    assert not any(isinstance(m, (port_resnet.BatchNorm,
                                  port_resnet.DeformBottleneckBlock))
                   for m in mods)
    assert all(s["dilation"] == 1 for s in pm.bottom_up.specs)
