"""The port's photometric, extent and rotation augmentations against the
JAX package's (``drn_wsod_tpu/data/transforms.py``, which resamples with
Pillow): from the same ``RandomState`` seed on the same uint8 BGR image and
coordinates, the drawn parameters, ``apply_image`` (exact: the port's
numpy sampler computes Pillow's ``Geometry.c`` in the same float64 order),
``apply_segmentation``, ``apply_coords``, ``output_size`` and Rotation's
``inverse`` are equal. One case pins the JAX package's rotation canvas
mismatch (ROADMAP.md section 3), and one packs a JPEG VOC directory with
both packages' ``pack_dataset``."""

import sys

import numpy as np
import pytest

from drn_wsod_torch import data as pdata
from drn_wsod_torch.data import record_dataset as prec
from drn_wsod_torch.data import transforms as pT
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_tpu.data import record_dataset as jrec
from drn_wsod_tpu.data import transforms as jT
from test_torch_common import write_voc

SHAPES = [(39, 36), (48, 64), (61, 45), (17, 90)]


def _image(h, w, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _seg(h, w, seed):
    return np.random.RandomState(seed + 1).randint(0, 21, (h, w)).astype(
        np.uint8)


def _coords(h, w, seed):
    rs = np.random.RandomState(seed + 2)
    return np.stack([rs.uniform(-5, w + 5, 16), rs.uniform(-5, h + 5, 16)],
                    1).astype(np.float32)


def _draw(aug_j, aug_p, img, seed):
    tj = aug_j.get_transform(img, np.random.RandomState(seed))
    tp = aug_p.get_transform(img, np.random.RandomState(seed))
    return tj, tp


def _same_blend(tj, tp):
    assert type(tj).__name__ == type(tp).__name__ == "BlendTransform"
    assert tj.src_weight == tp.src_weight
    assert tj.dst_weight == tp.dst_weight
    np.testing.assert_array_equal(np.asarray(tj.src_image),
                                  np.asarray(tp.src_image))


PHOTOMETRIC = [
    ("RandomBrightness", (0.5, 1.5)),
    ("RandomContrast", (0.5, 1.5)),
    ("RandomSaturation", (0.5, 1.5)),
    ("RandomLighting", (0.1,)),
    ("RandomLighting", (2.0,)),
]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name,args", PHOTOMETRIC,
                         ids=[f"{n}{a}" for n, a in PHOTOMETRIC])
def test_photometric_equal(name, args, shape):
    for seed in range(4):
        img = _image(*shape, seed)
        tj, tp = _draw(getattr(jT, name)(*args), getattr(pT, name)(*args),
                       img, seed)
        _same_blend(tj, tp)
        out = tp.apply_image(img)
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, tj.apply_image(img))
        f = img.astype(np.float32) / 3
        np.testing.assert_array_equal(tp.apply_image(f), tj.apply_image(f))
        c = _coords(*shape, seed)
        np.testing.assert_array_equal(tp.apply_coords(c), c)
        seg = _seg(*shape, seed)
        np.testing.assert_array_equal(tp.apply_segmentation(seg), seg)


def _jax_size(t, hw):
    """``t.output_size(hw)``; the JAX package's ``TransformList`` reads a
    missing ``self.tfms`` there (ROADMAP.md section 3), so its members'
    sizes are composed here."""
    for m in getattr(t, "transforms", [t]):
        hw = m.output_size(hw)
    return hw


def _same_geometry(tj, tp, shape, seed):
    h, w = shape
    img, seg, c = _image(h, w, seed), _seg(h, w, seed), _coords(h, w, seed)
    assert tp.output_size((h, w)) == _jax_size(tj, (h, w))
    a, b = tj.apply_image(img), tp.apply_image(img)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(tp.apply_segmentation(seg),
                                  tj.apply_segmentation(seg))
    np.testing.assert_array_equal(tp.apply_coords(c), tj.apply_coords(c))
    boxes = np.concatenate([c[:8], c[8:] + 3], 1)
    np.testing.assert_array_equal(tp.apply_box(boxes), tj.apply_box(boxes))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("scale,shift", [((0.8, 1.2), (0.2, 0.2)),
                                         ((0.5, 1.5), (0.6, 0.0)),
                                         ((1.0, 1.0), (0.0, 0.0))],
                         ids=["mild", "wide", "identity"])
def test_extent_equal(scale, shift, shape):
    for seed in range(6):
        img = _image(*shape, seed)
        tj, tp = _draw(jT.RandomExtent(scale, shift),
                       pT.RandomExtent(scale, shift), img, seed)
        assert tp.src_rect == tj.src_rect and tp.out_hw == tj.out_hw
        _same_geometry(tj, tp, shape, seed)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("angle,style", [((-30.0, 30.0), "range"),
                                         ((-180.0, 180.0), "range"),
                                         ((90.0, 180.0, 270.0, -90.0, 45.0,
                                           360.0), "choice")],
                         ids=["30", "180", "choice"])
def test_rotation_equal(angle, style, shape):
    for seed in range(6):
        img = _image(*shape, seed)
        tj, tp = _draw(jT.RandomRotation(angle, sample_style=style),
                       pT.RandomRotation(angle, sample_style=style), img,
                       seed)
        assert type(tj).__name__ == type(tp).__name__
        if isinstance(tp, pT.NoOpTransform):
            continue
        assert tp.angle == tj.angle
        assert (tp.new_h, tp.new_w) == (tj.new_h, tj.new_w)
        _same_geometry(tj, tp, shape, seed)
        ij, ip = tj.inverse(), tp.inverse()
        back = (tj.new_h, tj.new_w)
        assert ip.output_size(back) == _jax_size(ij, back)
        c = tj.apply_coords(_coords(*shape, seed))
        np.testing.assert_array_equal(ip.apply_coords(c), ij.apply_coords(c))
        big = _image(tj.new_h, tj.new_w, seed)
        np.testing.assert_array_equal(ip.apply_image(big),
                                      ij.apply_image(big))


@pytest.mark.parametrize("expand", [True, False])
@pytest.mark.parametrize("angle", [90.0, 180.0, 270.0, -90.0, 33.3, -147.2])
def test_rotation_transform_equal(angle, expand):
    shape = (29, 44)
    tj = jT.RotationTransform(*shape, angle, expand=expand)
    tp = pT.RotationTransform(*shape, angle, expand=expand)
    _same_geometry(tj, tp, shape, 7)


def test_rotation_size_mismatch_pinned():
    """The JAX package's canvas ``ceil(|h cos| + |w sin|)`` is not the
    canvas of the Pillow rotation it returns: at h=39, w=36, 139.9 degrees
    the image is (55, 54) and ``new_h, new_w`` are (54, 53). The port
    copies both; a fix in either package shows here."""
    img = _image(39, 36, 0)
    for T in (jT, pT):
        t = T.RotationTransform(39, 36, 139.9)
        assert t.apply_image(img).shape[:2] == (55, 54)
        assert (t.new_h, t.new_w) == (54, 53)
        assert t.output_size((39, 36)) == (54, 53)


def test_apply_augmentations_chain_equal():
    """All the new augmentations in one chain, drawn from one rng."""
    def augs(T):
        return [T.RandomBrightness(0.8, 1.2), T.RandomContrast(0.8, 1.2),
                T.RandomSaturation(0.8, 1.2), T.RandomLighting(0.5),
                T.RandomRotation((-20.0, 20.0)),
                T.RandomExtent((0.9, 1.1), (0.1, 0.1)), T.RandomFlip()]

    for seed in range(5):
        img = _image(45, 60, seed)
        oj, tj = jT.apply_augmentations(augs(jT), img,
                                        np.random.RandomState(seed))
        op, tp = pT.apply_augmentations(augs(pT), img,
                                        np.random.RandomState(seed))
        np.testing.assert_array_equal(op, oj)
        c = _coords(45, 60, seed)
        np.testing.assert_array_equal(tp.apply_coords(c), tj.apply_coords(c))
        assert tp.output_size((45, 60)) == _jax_size(tj, (45, 60))
        seg = _seg(45, 60, seed)
        np.testing.assert_array_equal(tp.apply_segmentation(seg),
                                      tj.apply_segmentation(seg))


def test_affine_resample_fixed_and_float_paths():
    """Nearest sampling takes Pillow's 16.16 fixed-point loop where the
    canvas corners map within 32768, else its float loop: both against
    Pillow itself."""
    from PIL import Image

    seg = _seg(40, 50, 3)
    for a in [(0.9, 0.3, 2.0, -0.25, 1.1, 5.0),
              (0.9, 0.3, 40000.0, -0.25, 1.1, 5.0),
              (1.3, 0.0, -3.0, 0.0, 0.7, 2.0)]:
        want = np.asarray(Image.fromarray(seg).transform(
            (37, 41), Image.AFFINE, a, Image.NEAREST))
        np.testing.assert_array_equal(
            pT.affine_resample(seg, 37, 41, a, bilinear=False), want)
        img = _image(40, 50, 4)
        want = np.asarray(Image.fromarray(img).transform(
            (37, 41), Image.AFFINE, a, Image.BILINEAR))
        np.testing.assert_array_equal(
            pT.affine_resample(img, 37, 41, a, bilinear=True), want)


def test_pack_dataset_jpeg_equal_without_pillow(tmp_path, monkeypatch):
    """The port's ``pack_dataset`` (its own decoder, Pillow blocked) and
    the JAX package's (its libjpeg binding) on the same JPEG VOC
    directory: equal decoded pixels and fields."""
    d, prop_file, images = write_voc(tmp_path, [(30, 41), (44, 36),
                                                (57, 63)],
                                     pvoc.VOC_CLASS_NAMES, seed=5)
    records = pdata.load_proposals_into_dataset(
        pvoc.load_voc_instances(d, "test"), prop_file)
    jrec.pack_dataset(records, str(tmp_path / "j.rec"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    prec.pack_dataset(records, str(tmp_path / "p.rec"))
    got = list(prec.RecordDataset(str(tmp_path / "p.rec")))
    want = list(jrec.RecordDataset(str(tmp_path / "j.rec")))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["image"].shape[:2] == images[g["image_id"]].shape[:2]
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["proposal_boxes"],
                                      w["proposal_boxes"])
