"""The port's eval-path data modules against the JAX package's, on a
VOC-layout directory and proposal pickles the tests write: the VOC loader,
the catalogs, proposal loading (XYXY and XYWH modes, current and legacy key
names), ``get_detection_dataset_dicts``, ``unique_boxes_mask``,
``BoxMode.convert``, the view sizes and buckets over VOC image sizes at the
flagship's TTA scales, the resize transform and ``read_image``. Everything
must be equal (host numpy on both sides)."""

import numpy as np
import pytest

from drn_wsod_torch import data as pdata
from drn_wsod_torch import tta as ptta
from drn_wsod_torch.data import transforms as pT
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_torch.structures import boxes as pboxes
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu import tta as jtta
from drn_wsod_tpu.data import mapper as jmapper
from drn_wsod_tpu.data import transforms as jT
from drn_wsod_tpu.data.datasets import voc as jvoc
from drn_wsod_tpu.structures import boxes as jboxes
from test_torch_common import write_voc

CLASSES = ("cat", "dog", "bird")
SIZES = [(40, 56), (64, 48), (33, 70), (50, 50)]
FLAGSHIP_SCALES = (480, 576, 672, 768, 864, 960, 1056, 1152)
VOC_SIZES = [(375, 500), (500, 375), (333, 500), (500, 333), (500, 500),
             (500, 486), (281, 500), (500, 400), (112, 500), (500, 122),
             (1, 1), (2000, 3000)]


def assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return write_voc(tmp_path_factory.mktemp("voc"), SIZES, CLASSES)


@pytest.fixture
def registered(voc):
    """One split registered under the same name in both catalogs."""
    name = "torch_eval_data_test"
    pvoc.register_pascal_voc(name, voc[0], "test", 2007, CLASSES)
    jvoc.register_pascal_voc(name, voc[0], "test", 2007, CLASSES)
    yield name
    for pkg in (pdata, jdata):
        pkg.DatasetCatalog.remove(name)


def test_load_voc_instances_equal(voc):
    got = pvoc.load_voc_instances(voc[0], "test", CLASSES)
    assert got == jvoc.load_voc_instances(voc[0], "test", CLASSES)
    assert got[-1]["annotations"] == [] and "height" not in got[-1]
    assert len(got[0]["annotations"]) >= 1


def test_catalogs_equal(registered):
    name = registered
    assert pdata.DatasetCatalog.get(name) == jdata.DatasetCatalog.get(name)
    assert name in pdata.DatasetCatalog
    assert vars(pdata.MetadataCatalog.get(name)) == \
        vars(jdata.MetadataCatalog.get(name))
    assert pdata.MetadataCatalog.get(name).get("year") == 2007
    with pytest.raises(KeyError):
        pvoc.register_pascal_voc(name, "x", "test", 2007)
    with pytest.raises(KeyError, match="not registered"):
        pdata.DatasetCatalog.get("torch_eval_data_missing")


def test_register_all_pascal_voc_names(tmp_path, monkeypatch):
    """The same splits and metadata, each package's catalogs emptied for
    the test (other tests may have registered VOC names elsewhere)."""
    for pkg in (pdata, jdata):
        monkeypatch.setattr(pkg.DatasetCatalog, "_registry", {})
        monkeypatch.setattr(pkg.MetadataCatalog, "_map", {})
    pvoc.register_all_pascal_voc(str(tmp_path))
    jvoc.register_all_pascal_voc(str(tmp_path))
    names = pdata.DatasetCatalog.list()
    assert names == jdata.DatasetCatalog.list()
    assert "voc_2007_test" in names and len(names) == 7
    for n in names:
        assert vars(pdata.MetadataCatalog.get(n)) == \
            vars(jdata.MetadataCatalog.get(n))
    pvoc.register_all_pascal_voc("elsewhere")       # kept as registered
    assert pdata.MetadataCatalog.get("voc_2007_test").dirname == \
        str(tmp_path / "VOC2007")


@pytest.mark.parametrize("xywh,legacy", [(False, False), (True, True),
                                         (True, False)],
                         ids=["xyxy", "xywh_legacy_keys", "xywh"])
def test_load_proposals_equal(tmp_path, xywh, legacy):
    d, prop_file, _ = write_voc(tmp_path, SIZES, CLASSES, seed=3,
                                xywh=xywh, legacy=legacy)
    records = pvoc.load_voc_instances(d, "test", CLASSES)
    got = pdata.load_proposals_into_dataset(records, prop_file)
    want = jdata.load_proposals_into_dataset(records, prop_file)
    assert_records_equal(got, want)
    logits = got[0]["proposal_objectness_logits"]
    assert (np.diff(logits) <= 0).all() and len(set(logits)) < len(logits)
    assert "proposal_boxes" not in records[0]        # copies, not in place


@pytest.mark.parametrize("filter_empty", [True, False])
def test_get_detection_dataset_dicts_equal(voc, registered, filter_empty):
    got = pdata.get_detection_dataset_dicts([registered], [voc[1]],
                                            filter_empty)
    want = jdata.get_detection_dataset_dicts([registered], [voc[1]],
                                             filter_empty)
    assert_records_equal(got, want)
    assert len(got) == len(SIZES) - filter_empty
    assert_records_equal(
        pdata.get_detection_dataset_dicts(registered),
        jdata.get_detection_dataset_dicts(registered))


def test_unique_boxes_mask_equal():
    rs = np.random.RandomState(0)
    boxes = rs.randint(0, 6, (400, 4)).astype(np.float32)   # duplicates
    boxes[::3] += rs.uniform(-0.4, 0.4, boxes[::3].shape)  # round together
    for scale in (1.0, 0.5, 1 / 16):
        got = pboxes.unique_boxes_mask(boxes, scale)
        np.testing.assert_array_equal(
            got, jboxes.unique_boxes_mask(boxes, scale))
        assert 0 < got.sum() < len(boxes)


def test_box_mode_convert_equal():
    rs = np.random.RandomState(1)
    b = rs.uniform(0, 100, (7, 3, 4)).astype(np.float32)
    for src, dst in ((0, 1), (1, 0), (0, 0)):
        got = pboxes.BoxMode.convert(b, pboxes.BoxMode(src),
                                     pboxes.BoxMode(dst))
        want = jboxes.BoxMode.convert(b, jboxes.BoxMode(src),
                                      jboxes.BoxMode(dst))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_size", [4000, 1000])
def test_views_and_buckets_equal(max_size):
    buckets = (512, 704, 896, 1216)
    for hw in VOC_SIZES:
        for size in FLAGSHIP_SCALES:
            assert pT.ResizeShortestEdge.target_size(*hw, size, max_size) == \
                jT.ResizeShortestEdge.target_size(*hw, size, max_size)
        for flip in (True, False):
            views = ptta.enumerate_views(hw, FLAGSHIP_SCALES, max_size, flip)
            assert views == jtta.enumerate_views(hw, FLAGSHIP_SCALES,
                                                 max_size, flip)
            for nh, nw, _ in views:
                assert pdata.pick_bucket(nh, nw, buckets) == \
                    jmapper.pick_bucket(nh, nw, buckets)
    # the flagship's 500x375 image: 16 views in six buckets, three of them
    # rounded up beyond INPUT.BUCKETS
    views = ptta.enumerate_views((375, 500), FLAGSHIP_SCALES, 4000, True)
    assert len(views) == 16
    assert [pdata.pick_bucket(nh, nw, buckets) for nh, nw, _ in views[::2]] \
        == [704, 896, 896, 1216, 1216, 1280, 1408, 1536]


def test_resize_transform_equal():
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    boxes = rs.uniform(0, 37, (20, 4)).astype(np.float32)
    for nh, nw in ((37, 53), (80, 111), (20, 29)):
        p, j = (m.ResizeTransform(37, 53, nh, nw) for m in (pT, jT))
        np.testing.assert_array_equal(p.apply_image(img), j.apply_image(img))
        got, want = p.apply_box(boxes), j.apply_box(boxes)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["BGR", "RGB"])
def test_read_image_equal(voc, fmt):
    d, _, images = voc
    for fid in images:
        path = f"{d}/JPEGImages/{fid}.jpg"
        got = pdata.read_image(path, fmt)
        want = jdata.read_image(path, fmt)
        assert got.dtype == want.dtype == np.uint8
        assert got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, want)


def test_read_image_without_pillow(voc, monkeypatch):
    """No other decoder stands behind Pillow: without it, a clear error."""
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        pdata.read_image(f"{voc[0]}/JPEGImages/000001.jpg")
