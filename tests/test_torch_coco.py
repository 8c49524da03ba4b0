"""The port's COCO-format datasets (``data/datasets/coco.py``,
``builtin_web.py``) against the JAX package's, on json files the test
writes: sparse category ids out of order, crowd boxes, an image without
annotations, segmentation (polygons and RLE), keypoints and area carried
through. Records and metadata must be equal, and every registration must
give the catalog the JAX package's names, with and without the optional
web and VOC-SBD json on disk."""

import json

import numpy as np
import pytest

from drn_wsod_torch import data as pdata
from drn_wsod_torch.data import datasets as pdatasets
from drn_wsod_torch.data.datasets import builtin_web as pweb
from drn_wsod_torch.data.datasets import coco as pcoco
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import builtin_web as jweb
from drn_wsod_tpu.data.datasets import coco as jcoco


def write_coco_json(path, n_images=6, n_cats=80, seed=0):
    """A COCO instances json: ``n_cats`` categories under sparse ids (COCO's
    1-90 gaps, listed in shuffled order), 0-4 boxes an image (XYWH floats,
    some crowd with RLE segmentation, the first among them, the rest
    polygons, some with keypoints, some without area), the last image
    without annotations.
    Returns the parsed dict."""
    rs = np.random.RandomState(seed)
    ids = sorted(rs.choice(np.arange(1, 91), n_cats, replace=False).tolist())
    cats = [{"id": int(i), "name": f"class_{i}", "supercategory": "thing"}
            for i in ids]
    cats = [cats[i] for i in rs.permutation(len(cats))]
    images, anns = [], []
    for i in range(n_images):
        h, w = int(rs.randint(40, 90)), int(rs.randint(40, 90))
        images.append({"id": 1000 + 7 * i, "file_name": f"{i:012d}.jpg",
                       "height": h, "width": w})
        if i == n_images - 1:
            continue
        for _ in range(rs.randint(2 if i == 0 else 0, 5)):
            x, y = float(rs.uniform(0, w / 2)), float(rs.uniform(0, h / 2))
            bw, bh = float(rs.uniform(1, w / 2)), float(rs.uniform(1, h / 2))
            crowd = int(rs.uniform() < 0.25 or not anns)   # one at least
            a = {"id": len(anns) + 1, "image_id": 1000 + 7 * i,
                 "category_id": int(ids[rs.randint(len(ids))]),
                 "bbox": [x, y, bw, bh], "iscrowd": crowd,
                 "segmentation": ({"counts": [3, 5, 2], "size": [h, w]}
                                  if crowd else
                                  [[x, y, x + bw, y, x + bw, y + bh]])}
            if rs.uniform() < 0.8:
                a["area"] = bw * bh
            if rs.uniform() < 0.3:
                a["keypoints"] = [int(v) for v in rs.randint(0, 40, 51)]
            anns.append(a)
    coco = {"images": images, "annotations": anns, "categories": cats}
    with open(path, "w") as f:
        json.dump(coco, f)
    return coco


def test_load_coco_json_matches_jax(tmp_path):
    path = str(tmp_path / "instances.json")
    coco = write_coco_json(path)
    got = pcoco.load_coco_json(path, "/data/coco_images", "torch_coco_meta")
    want = jcoco.load_coco_json(path, "/data/coco_images", "torch_coco_meta")
    assert got == want
    assert len(got) == 6 and got[-1]["annotations"] == []
    annos = [a for r in got for a in r["annotations"]]
    assert any(a["iscrowd"] and a["difficult"] for a in annos)
    assert any("keypoints" in a for a in annos)
    assert any("area" not in a for a in annos)
    assert {a["category_id"] for a in annos} <= set(range(80))
    pm = pdata.MetadataCatalog.get("torch_coco_meta")
    jm = jdata.MetadataCatalog.get("torch_coco_meta")
    for key in ("thing_classes", "thing_dataset_id_to_contiguous_id",
                "json_file", "image_root", "evaluator_type"):
        assert getattr(pm, key) == getattr(jm, key), key
    id_map = pm.thing_dataset_id_to_contiguous_id
    assert list(id_map) == sorted(c["id"] for c in coco["categories"])
    assert list(id_map.values()) == list(range(80))


def test_load_without_name_sets_no_metadata(tmp_path):
    path = str(tmp_path / "instances.json")
    write_coco_json(path, n_images=3, n_cats=5, seed=1)
    assert pcoco.load_coco_json(path, "root") == \
        jcoco.load_coco_json(path, "root")
    assert "torch_coco_unnamed" not in pdata.MetadataCatalog.list()


def write_panoptic_tree(root, split: str, seed: int = 1):
    """The json of a COCO panoptic-separated split under ``root/coco``:
    the instances json of ``write_coco_json`` and a panoptic json over its
    images (its things with isthing 1, three stuff categories listed out
    of id order, a segment of a category in neither list, the last image
    without a panoptic entry). Returns the panoptic dict."""
    rs = np.random.RandomState(seed)
    ann = root / "coco" / "annotations"
    ann.mkdir(parents=True, exist_ok=True)
    coco = write_coco_json(str(ann / f"instances_{split}.json"),
                           n_images=4, n_cats=6, seed=seed)
    things = [dict(c, isthing=1) for c in coco["categories"]]
    stuff = [{"id": i, "name": f"stuff_{i}", "isthing": 0}
             for i in (200, 95, 150)]
    annos = []
    for img in coco["images"][:-1]:
        segs = [{"id": int(k + 1), "category_id": int(c), "iscrowd": 0}
                for k, c in enumerate(rs.choice(
                    [c["id"] for c in things + stuff] + [999], 5))]
        annos.append({"image_id": img["id"],
                      "file_name": img["file_name"][:-4] + ".png",
                      "segments_info": segs})
    pan = {"images": coco["images"], "annotations": annos,
           "categories": things + stuff}
    (ann / f"panoptic_{split}.json").write_text(json.dumps(pan))
    return pan


@pytest.fixture
def clean_catalogs():
    """Both packages' dataset and metadata catalogs empty for the test,
    and put back exactly as they were after it. An earlier test in the
    same process may have left builtin names (VOC, COCO, LVIS, Cityscapes,
    the web sets) registered in one package's catalog and not in the
    other's, through a ``register_all_*`` or a CLI's ``main``; the
    registrations under test would then add different names in the two."""
    saved = [(pkg, dict(pkg.DatasetCatalog._registry),
              dict(pkg.MetadataCatalog._map)) for pkg in (pdata, jdata)]
    for pkg, _, _ in saved:
        pkg.DatasetCatalog.clear()
        pkg.MetadataCatalog.clear()
    yield
    for pkg, registry, metadata in saved:
        pkg.DatasetCatalog.clear()
        pkg.DatasetCatalog._registry.update(registry)
        pkg.MetadataCatalog.clear()
        pkg.MetadataCatalog._map.update(metadata)


def _registered(pkg, register, root):
    before = set(pkg.DatasetCatalog.list())
    register(str(root))
    return sorted(set(pkg.DatasetCatalog.list()) - before)


@pytest.mark.parametrize("with_json", [False, True])
def test_registrations_match_jax(tmp_path, clean_catalogs, with_json):
    """``register_all_coco``, ``register_all_web`` and
    ``register_all_voc_sbd`` add the JAX package's names under the same
    root; the web and SBD splits only where their json exists."""
    if with_json:
        for rel in ("flickr_voc/annotations/instances.json",
                    "VOC_SBD/annotations/sbd_9118_instance.json"):
            (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
            write_coco_json(str(tmp_path / rel), n_images=2, n_cats=20)
    for preg, jreg in ((pcoco.register_all_coco, jcoco.register_all_coco),
                       (pweb.register_all_web, jweb.register_all_web),
                       (pweb.register_all_voc_sbd,
                        jweb.register_all_voc_sbd)):
        got = _registered(pdata, preg, tmp_path)
        assert got == _registered(jdata, jreg, tmp_path)
        for name in got:
            assert pdata.MetadataCatalog.get(name).evaluator_type == \
                jdata.MetadataCatalog.get(name).evaluator_type
    names = set(pdata.DatasetCatalog.list())
    assert {"coco_2014_train", "coco_2017_val",
            "coco_2017_val_panoptic_separated"} <= names
    assert ("flickr_voc" in names) == with_json
    assert ("sbd_9118_instance" in names) == with_json
    assert "flickr_coco" not in names
    if with_json:
        got = pdata.DatasetCatalog.get("flickr_voc")
        assert got == jdata.DatasetCatalog.get("flickr_voc")
        assert len(got) == 2
    # the panoptic split (it raised item 15 until its loader was ported)
    # loads as the JAX package's does
    write_panoptic_tree(tmp_path, "train2017")
    name = "coco_2017_train_panoptic_separated"
    got = pdata.DatasetCatalog.get(name)
    assert got == jdata.DatasetCatalog.get(name)
    assert all("sem_seg_file_name" in r for r in got[:-1])
    for key in ("stuff_classes", "stuff_dataset_id_to_contiguous_id",
                "thing_classes", "evaluator_type", "panoptic_root"):
        assert pdata.MetadataCatalog.get(name).get(key) == \
            jdata.MetadataCatalog.get(name).get(key)
    # registering again adds nothing
    assert _registered(pdata, pcoco.register_all_coco, tmp_path) == []


def test_register_all_is_the_jax_cli_set(tmp_path, clean_catalogs):
    """``datasets.register_all`` registers what the JAX CLI's ``main``
    does, LVIS included; Cityscapes, which that ``main`` does not
    register, is left out here too."""
    from drn_wsod_tpu.data.datasets.cityscapes import \
        register_all_cityscapes
    from drn_wsod_tpu.data.datasets.lvis import register_all_lvis
    from drn_wsod_tpu.data.datasets.voc import register_all_pascal_voc

    got = _registered(pdata, pdatasets.register_all, tmp_path)

    def jax_cli(root):
        register_all_pascal_voc(root)
        jcoco.register_all_coco(root)
        register_all_lvis(root)
        jweb.register_all_web(root)
        jweb.register_all_voc_sbd(root)
    want = _registered(jdata, jax_cli, tmp_path)
    assert got == want
    assert {"lvis_v1_train", "lvis_v1_val"} <= set(got)
    cityscapes = _registered(jdata, register_all_cityscapes, tmp_path)
    assert cityscapes and not set(cityscapes) & set(got)


def test_voc_colormap_matches_jax():
    np.testing.assert_array_equal(pweb.voc_label_colormap(),
                                  jweb.voc_label_colormap())
    assert pweb.VOC_COLORMAP == jweb.VOC_COLORMAP
