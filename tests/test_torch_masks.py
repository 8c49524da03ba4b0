"""The mask structures, the polygon rasterizer and the Mask R-CNN head
against Pillow and the JAX package, on the CPU.

  * ``fill_polygon`` bit-equal to Pillow 12's ``ImageDraw.polygon`` under
    hypothesis (``fill=1`` and ``outline=1, fill=1``): float, integer and
    half-integer vertices, concave and self-intersecting polygons,
    vertices off the canvas, rectilinear runs, 2 to 12 points; and to the
    JAX package's ``rasterize_polygons`` (structures and evaluator), which
    skip polygons of fewer than 3 points, with several polygons to an
    instance. It needs no Pillow. Pillow truncates each vertex toward zero
    before it fills (its ``_draw_polygon`` casts the doubles to int).
  * the committed fixtures (``drn_wsod_torch/data/mask_fixtures``): the
    manifest equal to a fresh build with Pillow, its digests reproduced by
    the port's rasterizer and by the port's and the JAX package's training
    mappers of the Mask R-CNN YAML;
  * ``BitMasks`` and ``PolygonMasks`` (area, boxes, ``crop_and_resize``,
    indexing) equal to the JAX package's, ``paste_masks_in_image`` exactly;
  * ``MaskRCNNHead`` against flax's: float32 within rtol 1e-5 (atol 1e-6
    times the largest logit), bfloat16 within a bfloat16 ulp of the
    largest; ``mask_loss`` within rtol 1e-6;
  * the transposed conv: flax's ``ConvTranspose`` (k 2 or 4, stride 2,
    "SAME") is ``F.conv_transpose2d`` with the kernel flipped in both
    spatial axes at padding (k - 2) / 2, and not without the flip; the
    bridge flips it; the Detectron2 import loads the mask head's deconv as
    the JAX import does (in and out swapped, unflipped) and refuses the
    keypoint head's ``score_lowres`` as it does.
"""

import json
import pickle
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageDraw

import drn_wsod_torch
from drn_wsod_torch.checkpoint.torch_import import load_reference_weights
from drn_wsod_torch.models.heads import seg as port_seg
from drn_wsod_torch.ops.mask_ops import paste_masks_in_image
from drn_wsod_torch.structures import masks as port_masks
from drn_wsod_torch.tools import make_mask_fixtures as fixtures
from drn_wsod_tpu.checkpoint import torch_import as jimport
from drn_wsod_tpu.data.mapper import DatasetMapper as JaxMapper
from drn_wsod_tpu.evaluation import coco_eval as jax_coco_eval
from drn_wsod_tpu.models.heads import seg as jax_seg
from drn_wsod_tpu.ops.mask_ops import paste_masks_in_image as jax_paste
from drn_wsod_tpu.structures import masks as jax_masks
from test_torch_common import (flatten, load_prefixed, random_params,
                               unflatten)

torch.set_num_threads(1)


def pillow_fill(polys, h, w, outline=None):
    im = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(im)
    for p in polys:
        draw.polygon([tuple(q) for q in np.reshape(p, (-1, 2))],
                     outline=outline, fill=1)
    return np.asarray(im, bool)


def port_fill(polys, h, w):
    out = np.zeros((h, w), bool)
    for p in polys:
        port_masks.fill_polygon(out, np.reshape(p, (-1, 2)))
    return out


def _points(kind, n, h, w, rng):
    span = max(h, w)
    if kind == "float":
        return rng.uniform(-0.3 * span, 1.3 * span, (n, 2))
    if kind == "int":
        return rng.randint(-5, span + 5, (n, 2)).astype(np.float64)
    if kind == "half":
        return (rng.randint(-10, 2 * span + 10, (n, 2)) / 2.0)
    # rectilinear: alternate x and y moves on a coarse grid
    pts = [rng.randint(0, span, 2).astype(np.float64)]
    for k in range(1, n):
        q = pts[-1].copy()
        q[k % 2] = rng.randint(-3, span + 3)
        pts.append(q)
    return np.stack(pts)


@settings(max_examples=300, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48), n=st.integers(2, 12),
       kind=st.sampled_from(["float", "int", "half", "rect"]),
       outline=st.sampled_from([None, 1]), seed=st.integers(0, 2 ** 16))
def test_fill_polygon_equals_pillow(h, w, n, kind, outline, seed):
    pts = _points(kind, n, h, w, np.random.RandomState(seed))
    np.testing.assert_array_equal(port_fill([pts], h, w),
                                  pillow_fill([pts], h, w, outline))


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 300), w=st.integers(1, 300), n=st.integers(3, 60),
       seed=st.integers(0, 2 ** 16))
def test_star_polygons_equal_pillow(h, w, n, seed):
    """COCO-like outlines of many vertices on larger canvases."""
    rng = np.random.RandomState(seed)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.1, 0.6, n) * max(h, w)
    c = rng.uniform(-0.2, 1.2, 2) * (w, h)
    pts = c + np.stack([rad * np.cos(ang), rad * np.sin(ang)], -1)
    np.testing.assert_array_equal(port_fill([pts], h, w),
                                  pillow_fill([pts], h, w))


def test_pillow_truncates_vertices():
    """Why the port fills integer vertices: Pillow's fill of float
    vertices equals its fill of the vertices truncated toward zero, and
    rounding them instead would change the mask."""
    rng = np.random.RandomState(0)
    changed = 0
    for _ in range(50):
        pts = rng.uniform(-6, 40, (6, 2))
        assert (pillow_fill([pts], 36, 36)
                == pillow_fill([np.trunc(pts)], 36, 36)).all()
        changed += (pillow_fill([pts], 36, 36)
                    != pillow_fill([np.round(pts)], 36, 36)).any()
    assert changed > 25
    np.testing.assert_array_equal(
        port_masks.pillow_vertices([[2.9, -2.9], [-0.5, 7.0]]),
        [[2, -2], [0, 7]])


def test_fewer_than_two_points_raise_as_pillow():
    for pts in ([], [(3.0, 4.0)]):
        with pytest.raises(TypeError):
            pillow_fill([pts], 8, 8)
        with pytest.raises(TypeError, match="at least 2"):
            port_fill([pts], 8, 8)


@pytest.mark.parametrize("seed", range(6))
def test_rasterize_polygons_equals_jax(seed):
    """Several polygons to an instance, one of two points (skipped by
    both): the JAX structures' rasterizer (``outline=1, fill=1``) and the
    evaluator's (``fill=1``)."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(10, 120, 2)
    polys = [list(_points(k, rng.randint(3, 10), h, w, rng).ravel())
             for k in ("float", "int", "half")]
    polys.append([1.5, 2.5, float(w) - 2, float(h) - 3])
    got = port_masks.rasterize_polygons(polys, h, w)
    np.testing.assert_array_equal(got,
                                  jax_masks.rasterize_polygons(polys, h, w))
    np.testing.assert_array_equal(
        got, jax_coco_eval.rasterize_polygons(polys, h, w))
    assert got.any()


def test_rasterizer_needs_no_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setitem(sys.modules, "PIL.ImageDraw", None)
    case = fixtures.load_manifest()["polygons"][0]
    got = port_fill(case["polygons"], case["height"], case["width"])
    assert fixtures.mask_digest(got) == case["sha256"]


# ------------------------------------------------------------------ fixtures
MANIFEST = fixtures.load_manifest()


def test_committed_fixtures_equal_a_fresh_build():
    """The committed manifest is what the tool writes now (Pillow draws
    its digests), so a stale fixture shows."""
    fresh = json.loads(json.dumps(fixtures.build_manifest(MANIFEST["seed"]),
                                  sort_keys=True))
    assert fresh == MANIFEST


def test_fixture_polygons_match():
    assert len(MANIFEST["polygons"]) >= 40
    for c in MANIFEST["polygons"]:
        got = port_fill(c["polygons"], c["height"], c["width"])
        assert fixtures.mask_digest(got) == c["sha256"], c


@pytest.fixture(scope="module")
def mapper_records():
    return fixtures.coco_records(MANIFEST["coco"]["train"])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_mapper_masks_match_fixture_digests(package, mapper_records,
                                            monkeypatch):
    """The training mapper of the Mask R-CNN YAML on the fixture records,
    each with its seed: every instance's mask (G = 100 slots, the rest
    empty) against the digests; the port's with Pillow blocked."""
    if package == "port":
        mapper = drn_wsod_torch.data.DatasetMapper(
            fixtures.mask_mapper_cfg(), is_train=True)
        monkeypatch.setitem(sys.modules, "PIL", None)
    else:
        from drn_wsod_tpu.config import get_cfg

        cfg = get_cfg()
        cfg.merge_from_file(str(fixtures.MASK_YAML))
        mapper = JaxMapper(cfg, is_train=True)
    n_masks = 0
    for r, e in zip(mapper_records, MANIFEST["mapper"]):
        assert r["image_id"] == e["image_id"]
        out = mapper(dict(r), np.random.RandomState(e["seed"]))
        gm = np.asarray(out["gt_masks"])
        assert out["_bucket"] == e["bucket"]
        assert gm.shape == (100, e["bucket"], e["bucket"])
        if package == "port":
            assert gm.dtype == np.uint8
        n = len(e["masks_sha256"])
        assert [fixtures.mask_digest(m) for m in gm[:n]] == e["masks_sha256"]
        assert not gm[n:].any()
        n_masks += n
    assert n_masks >= 20


def test_fixture_coco_data():
    """The Mask R-CNN phase's data: 1-5 polygon instances an image, some
    of two polygons, one crowd region as RLE, an image without
    annotations in each split."""
    for split, n in (("train", 8), ("test", 2)):
        coco = MANIFEST["coco"][split]
        assert len(coco["images"]) == n
        by_image = {i["id"]: [] for i in coco["images"]}
        for a in coco["annotations"]:
            by_image[a["image_id"]].append(a)
        assert sum(not v for v in by_image.values()) == 1
    annos = MANIFEST["coco"]["train"]["annotations"]
    assert sum(isinstance(a["segmentation"], dict) for a in annos) == 1
    assert any(len(a["segmentation"]) == 2 for a in annos
               if isinstance(a["segmentation"], list))


# ---------------------------------------------------------------- structures
def _polygon_masks(rng, h, w, n):
    return [[(rng.uniform(-0.1, 1.1, (rng.randint(3, 9), 2)) * (w, h))
             .ravel().tolist() for _ in range(rng.randint(1, 3))]
            for _ in range(n)] + [[]]


@pytest.mark.parametrize("seed", range(4))
def test_polygon_and_bit_masks_equal_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(20, 90, 2)
    polys = _polygon_masks(rng, h, w, 4)
    pp, jp = port_masks.PolygonMasks(polys), jax_masks.PolygonMasks(polys)
    np.testing.assert_array_equal(pp.area(), jp.area())
    np.testing.assert_array_equal(pp.nonempty(), jp.nonempty())
    np.testing.assert_array_equal(pp.get_bounding_boxes(),
                                  jp.get_bounding_boxes())
    boxes = jp.get_bounding_boxes() + rng.uniform(-2, 2, (5, 4)).astype(
        np.float32)
    boxes[-1] = (3.3, 2.1, 3.3, 9.0)                 # a zero-width box
    for size in (7, 28):
        np.testing.assert_array_equal(pp.crop_and_resize(boxes, size),
                                      jp.crop_and_resize(boxes, size))
    for item in (1, slice(1, 3), np.array([True, False, True, False, True]),
                 [3, 0]):
        assert pp[item].polygons.__len__() == jp[item].polygons.__len__()
        for a, b in zip(pp[item].polygons, jp[item].polygons):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    pb = port_masks.BitMasks.from_polygon_masks(pp, h, w)
    jb = jax_masks.BitMasks.from_polygon_masks(jp, h, w)
    np.testing.assert_array_equal(pb.tensor, jb.tensor)
    np.testing.assert_array_equal(pb.area(), jb.area())
    np.testing.assert_array_equal(pb.get_bounding_boxes(),
                                  jb.get_bounding_boxes())
    boxes[0] = (-4.2, -3.0, w + 2.5, h + 7.0)        # beyond the mask
    for size in (7, 14, 28):
        np.testing.assert_array_equal(pb.crop_and_resize(boxes, size),
                                      jb.crop_and_resize(boxes, size))
    np.testing.assert_array_equal(pb[1:3].tensor, jb[1:3].tensor)
    assert len(port_masks.BitMasks.from_polygon_masks(
        port_masks.PolygonMasks([]), h, w)) == 0


@pytest.mark.parametrize("seed", range(4))
def test_paste_masks_equals_jax_exactly(seed):
    rng = np.random.RandomState(seed)
    H, W, N, m = 57, 83, 12, 28
    probs = rng.uniform(0, 1, (N, m, m)).astype(np.float32)
    xy = rng.uniform(-20, 90, (N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.2, 60, (N, 2))], 1)
    boxes[0] = (10.0, 10.0, 10.0, 30.0)              # empty: skipped
    boxes[1] = (-30.0, -30.0, -5.0, -5.0)            # off the image
    boxes = boxes.astype(np.float32)
    got = paste_masks_in_image(probs, boxes, (H, W))
    np.testing.assert_array_equal(got, jax_paste(probs, boxes, (H, W)))
    assert got[2:].any() and not got[:2].any()


# ---------------------------------------------------------------- mask head
def _mask_head_pair(dtype, num_classes=5, conv_dim=32, seed=1):
    jm = jax_seg.MaskRCNNHead(num_classes=num_classes, conv_dim=conv_dim,
                              dtype=jnp.bfloat16 if dtype == torch.bfloat16
                              else jnp.float32)
    x = np.zeros((1, 7, 7, 16), np.float32)
    shapes = {k: v.shape for k, v in flatten(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), x))["params"]).items()}
    flat = random_params(shapes, seed)
    pm = port_seg.MaskRCNNHead(16, num_classes, conv_dim=conv_dim,
                               dtype=dtype)
    load_prefixed(pm, flat, "mask_head.", "mask_head.")
    return jm, flat, pm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_head_matches_flax(dtype):
    jm, flat, pm = _mask_head_pair(dtype)
    x = np.random.RandomState(2).randn(6, 7, 7, 16).astype(np.float32)
    want = np.asarray(jm.apply({"params": unflatten(flat)}, x))
    got = pm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (6, 14, 14, 5)
    assert got.dtype == np.float32
    top = np.abs(want).max()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * top)
    else:
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        assert np.abs(got - want).max() <= ulp


def test_mask_loss_matches_jax():
    rng = np.random.RandomState(3)
    N, m, C = 12, 14, 6
    logits = (rng.randn(N, m, m, C) * 3).astype(np.float32)
    cls = rng.randint(-1, C + 2, N).astype(np.int32)
    target = (rng.rand(N, m, m) < 0.4).astype(np.float32)
    for fg in (rng.rand(N) < 0.6, np.zeros(N, bool)):
        want = float(jax_seg.mask_loss(jnp.asarray(logits), jnp.asarray(cls),
                                       jnp.asarray(target), jnp.asarray(fg)))
        got = float(port_seg.mask_loss(torch.from_numpy(logits),
                                       torch.from_numpy(cls),
                                       torch.from_numpy(target),
                                       torch.from_numpy(fg)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        port_seg.optax_sigmoid_bce(torch.from_numpy(logits),
                                   torch.ones(N, m, m, C)).numpy(),
        np.asarray(jax_seg.optax_sigmoid_bce(jnp.asarray(logits), 1.0)),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose_is_a_flipped_kernel(k):
    """The identity the bridge rests on, in float32: flax's
    ``ConvTranspose`` equals ``F.conv_transpose2d`` of the flipped kernel
    at padding (k - 2) / 2 (to 1e-6; measured 0 at k 2), and the unflipped
    kernel does not."""
    rng = np.random.RandomState(k)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    mod = fnn.ConvTranspose(3, (k, k), strides=(2, 2), use_bias=False)
    kern = rng.randn(k, k, 8, 3).astype(np.float32)
    want = np.asarray(mod.apply({"params": {"kernel": kern}}, x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def torch_out(kk):
        w = torch.from_numpy(np.ascontiguousarray(kk.transpose(2, 3, 0, 1)))
        return F.conv_transpose2d(xt, w, None, 2, (k - 2) // 2).permute(
            0, 2, 3, 1).numpy()
    got = torch_out(kern[::-1, ::-1])
    assert got.shape == want.shape == (2, 12, 10, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(torch_out(kern) - want).max() > 1e-2
    sd = drn_wsod_torch.params_from_jax(
        {"mask_head.deconv.kernel": kern, "mask_head.deconv.bias":
         np.zeros(3, np.float32)})
    np.testing.assert_array_equal(sd["mask_head.deconv.weight"].numpy(),
                                  kern[::-1, ::-1].transpose(2, 3, 0, 1))


def _d2_checkpoint(tmp_path, flat, rng):
    """A Detectron2-named .pkl of fresh weights for the heads of ``flat``
    (its flax names): OIHW convs, (in, out, k, k) transposed convs."""
    out = {}
    for name, v in flat.items():
        d2 = "roi_heads." + name.replace(".kernel", ".weight")
        if v.ndim == 4 and ("deconv" in name or "score_lowres" in name):
            kh, kw, i, o = v.shape
            out[d2] = rng.randn(i, o, kh, kw).astype(np.float32)
        elif v.ndim == 4:
            kh, kw, i, o = v.shape
            out[d2] = rng.randn(o, i, kh, kw).astype(np.float32)
        else:
            out[d2] = rng.randn(*v.shape).astype(np.float32)
    path = tmp_path / "heads.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": out}, f)
    return str(path), out


def test_d2_import_of_the_mask_deconv_is_jax_s(tmp_path):
    """The mask head's 256 -> 256 deconv: the JAX import turns the
    Detectron2 (in, out, k, k) weight with (2, 3, 1, 0) into a flax kernel
    whose in and out are swapped and whose taps are not flipped; the port
    loads the model that kernel makes (the bridge of it)."""
    _, flat, pm = _mask_head_pair(torch.float32, conv_dim=256)
    flat = {"mask_head." + k: v for k, v in flat.items()}
    path, d2 = _d2_checkpoint(tmp_path, flat, np.random.RandomState(4))

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mask_head = pm
    unmatched, missing = load_reference_weights(path, Wrap())
    assert not unmatched and not missing
    loaded = jimport.load_reference_weights(
        path, {"params": unflatten(flat)})
    want = drn_wsod_torch.params_from_jax(flatten(loaded["params"]))
    for n, t in pm.state_dict().items():
        np.testing.assert_array_equal(t.detach().numpy(),
                                      want["mask_head." + n]
                                      .numpy(), err_msg=n)
    w = d2["roi_heads.mask_head.deconv.weight"]
    got = pm.deconv.weight.detach().numpy()
    np.testing.assert_array_equal(got,
                                  w.transpose(1, 0, 2, 3)[:, :, ::-1, ::-1])
    assert not np.array_equal(got, w)


def test_d2_import_of_the_keypoint_deconv_raises_as_jax(tmp_path):
    """The keypoint head's ``score_lowres`` (512 -> 17): the JAX import's
    (k, k, out, in) kernel does not fit (k, k, in, out), and both imports
    raise the shape ``ValueError``."""
    from drn_wsod_torch.models.heads.keypoint import \
        KRCNNConvDeconvUpsampleHead
    from drn_wsod_tpu.models.heads.keypoint import \
        KRCNNConvDeconvUpsampleHead as JaxHead

    jm = JaxHead(conv_dims=(32,) * 2)
    x = np.zeros((1, 4, 4, 16), np.float32)
    shapes = {"keypoint_head." + k: v.shape for k, v in flatten(
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
        ["params"]).items()}
    flat = random_params(shapes, 0)
    path, _ = _d2_checkpoint(tmp_path, flat, np.random.RandomState(5))

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.keypoint_head = KRCNNConvDeconvUpsampleHead(
                16, conv_dims=(32,) * 2)
    msg = r"Shape mismatch for keypoint_head\.score_lowres\.kernel"
    with pytest.raises(ValueError, match=msg):
        jimport.load_reference_weights(path, {"params": unflatten(flat)})
    with pytest.raises(ValueError, match=msg):
        load_reference_weights(path, Wrap())
