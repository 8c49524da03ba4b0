"""LVIS and Cityscapes data and evaluators against the JAX package, on the
CPU: the loaders' records and metadata equal on files the test writes (an
LVIS v1-shaped json whose file names are only in ``coco_url`` for most
images; a Cityscapes tree with a crowd "cargroup", a deleted object and a
label outside the 8 classes), the registrations' names, the LVIS and both
Cityscapes evaluators bit for bit on seeded detections (negative and
not-exhaustive classes, crowd regions, ``merge_states``), the four
evaluator types of ``build_evaluator``, and ``do_test`` on a toy LVIS
split against the JAX package's ``tools/train_net.py:do_test`` (the COCO
YAML at the toy size of ``tests/test_torch_coco_train_net.py``, one
Detectron2 ``.pkl`` loaded by both): each image's detections as in
``tests/test_torch_eval_slice.py``, the LVIS metrics within 1e-6 (NaN
where the JAX package gives NaN), and the port's evaluator on the JAX
package's detections bit for bit."""

import json
import pickle

import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch import data as pdata
from drn_wsod_torch.data.datasets import cityscapes as pcity
from drn_wsod_torch.data.datasets import lvis as plvis
from drn_wsod_torch.evaluation import cityscapes_eval as pceval
from drn_wsod_torch.evaluation import lvis_eval as plveval
from drn_wsod_torch.tools import train_net
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import cityscapes as jcity
from drn_wsod_tpu.data.datasets import lvis as jlvis
from drn_wsod_tpu.evaluation import cityscapes_eval as jceval
from drn_wsod_tpu.evaluation import lvis_eval as jlveval
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (CONFIGS, TOY, assert_detections_match,
                               cfg_pair, d2_state_dict, jax_batch,
                               param_shapes, random_params)
from test_torch_train_net import _jax_train_net

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TOPK = 3
COCO_YAML = str(CONFIGS / "COCO-Detection" / "oicr_WSR_50_DC5_1x.yaml")


def write_lvis_json(path, n_images=6, n_cats=7, seed=0):
    """An LVIS v1-shaped json: categories under sparse ids with r/c/f
    frequencies (one without), images named only by ``coco_url`` but the
    first, each with negative and not-exhaustive classes, 0-4 boxes an
    image (XYWH floats), the last image without annotations. Returns the
    parsed dict."""
    rs = np.random.RandomState(seed)
    ids = sorted(rs.choice(np.arange(1, 1204), n_cats, replace=False)
                 .tolist())
    cats = []
    for k, i in enumerate(ids):
        c = {"id": int(i), "name": f"lvis_{i}", "synset": f"s{i}.n.01"}
        if k:
            c["frequency"] = "rcf"[k % 3]
        cats.append(c)
    cats = [cats[i] for i in rs.permutation(len(cats))]
    images, anns = [], []
    for i in range(n_images):
        h, w = int(rs.randint(40, 90)), int(rs.randint(40, 90))
        img = {"id": 2000 + 3 * i, "height": h, "width": w,
               "coco_url": f"http://images.cocodataset.org/train2017/"
                           f"{i:012d}.jpg"}
        if i == 0:
            img["file_name"] = f"{i:012d}.jpg"
        negs = rs.choice(ids, 2, replace=False)
        img["neg_category_ids"] = [int(c) for c in negs]
        img["not_exhaustive_category_ids"] = [int(rs.choice(ids))]
        images.append(img)
        if i == n_images - 1:
            continue
        for _ in range(rs.randint(1, 5)):
            x, y = float(rs.uniform(0, w / 2)), float(rs.uniform(0, h / 2))
            bw, bh = float(rs.uniform(4, w / 2)), float(rs.uniform(4, h / 2))
            cat = int(rs.choice([c for c in ids if c not in negs]))
            anns.append({"id": len(anns) + 1, "image_id": img["id"],
                         "category_id": cat, "bbox": [x, y, bw, bh],
                         "area": bw * bh})
    data = {"images": images, "annotations": anns, "categories": cats}
    with open(path, "w") as f:
        json.dump(data, f)
    return data


def _poly(rs, w, h):
    x, y = rs.uniform(0, w * 0.6), rs.uniform(0, h * 0.6)
    bw, bh = rs.uniform(4, w * 0.4), rs.uniform(4, h * 0.4)
    return [[float(x), float(y)], [float(x + bw), float(y)],
            [float(x + bw), float(y + bh)], [float(x), float(y + bh)]]


def write_cityscapes(root, n_per_split=(3, 2), seed=0, size=(48, 64)):
    """A Cityscapes tree under ``root/cityscapes``: two cities of
    ``*_leftImg8bit.png`` images (their bytes unread by the loaders),
    polygon json files with every thing class, a "cargroup" crowd region,
    a deleted object and a "road" outside the 8 classes, and labelIds
    files."""
    rs = np.random.RandomState(seed)
    h, w = size
    labels = ["person", "rider", "car", "truck", "bus", "train",
              "motorcycle", "bicycle", "cargroup", "road", "persongroup"]
    for split, n in zip(("train", "val"), n_per_split):
        for k in range(n):
            city = ("aachen", "bochum")[k % 2]
            stem = f"{city}_{k:06d}_000019_"
            img_dir = root / "cityscapes" / "leftImg8bit" / split / city
            gt_dir = root / "cityscapes" / "gtFine" / split / city
            img_dir.mkdir(parents=True, exist_ok=True)
            gt_dir.mkdir(parents=True, exist_ok=True)
            (img_dir / f"{stem}leftImg8bit.png").write_bytes(b"png")
            (img_dir / f"{stem}other.txt").write_bytes(b"skip")
            (gt_dir / f"{stem}gtFine_labelIds.png").write_bytes(b"png")
            objs = []
            for j in range(rs.randint(3, 7)):
                obj = {"label": labels[rs.randint(len(labels))],
                       "polygon": _poly(rs, w, h)}
                if j == 1:
                    obj["deleted"] = 1
                objs.append(obj)
            with open(gt_dir / f"{stem}gtFine_polygons.json", "w") as f:
                json.dump({"imgHeight": h, "imgWidth": w,
                           "objects": objs}, f)
    (root / "cityscapes" / "leftImg8bit" / "train" / "README").write_text("")


@pytest.fixture
def clean_catalogs():
    before = [(pkg, set(pkg.DatasetCatalog.list())) for pkg in (pdata, jdata)]
    yield
    for pkg, names in before:
        for name in set(pkg.DatasetCatalog.list()) - names:
            pkg.DatasetCatalog.remove(name)


def test_load_lvis_json_matches_jax(tmp_path, clean_catalogs):
    jf = str(tmp_path / "lvis.json")
    write_lvis_json(jf, seed=3)
    got = plvis.load_lvis_json(jf, "/imgs", "p_lvis")
    want = jlvis.load_lvis_json(jf, "/imgs", "p_lvis")
    assert got == want
    assert got[0]["file_name"] == "/imgs/000000000000.jpg"
    assert got[1]["file_name"] == "/imgs/000000000001.jpg"
    assert any(r["neg_category_ids"] for r in got)
    pm, jm = (pkg.MetadataCatalog.get("p_lvis") for pkg in (pdata, jdata))
    for key in ("thing_classes", "thing_frequencies", "json_file",
                "image_root", "evaluator_type"):
        assert pm.get(key) == jm.get(key), key
    assert pm.thing_frequencies.count("f") >= 1


def test_register_all_lvis_matches_jax(tmp_path, clean_catalogs):
    (tmp_path / "lvis").mkdir()
    for split in ("train", "val"):
        write_lvis_json(str(tmp_path / "lvis" / f"lvis_v1_{split}.json"),
                        seed=len(split))
    for pkg, mod in ((pdata, plvis), (jdata, jlvis)):
        before = set(pkg.DatasetCatalog.list())
        mod.register_all_lvis(str(tmp_path))
        assert set(pkg.DatasetCatalog.list()) - before == {
            "lvis_v1_train", "lvis_v1_val"}
    for name in ("lvis_v1_train", "lvis_v1_val"):
        assert pdata.DatasetCatalog.get(name) == \
            jdata.DatasetCatalog.get(name)
        for key in ("thing_classes", "thing_frequencies", "evaluator_type",
                    "image_root", "json_file"):
            assert pdata.MetadataCatalog.get(name).get(key) == \
                jdata.MetadataCatalog.get(name).get(key)


def test_cityscapes_loaders_match_jax(tmp_path, clean_catalogs):
    write_cityscapes(tmp_path, seed=5)
    for split in ("train", "val"):
        img = str(tmp_path / "cityscapes" / "leftImg8bit" / split)
        gt = str(tmp_path / "cityscapes" / "gtFine" / split)
        assert pcity._files(img, gt) == jcity._files(img, gt)
        got = pcity.load_cityscapes_instances(img, gt)
        assert got == jcity.load_cityscapes_instances(img, gt)
        assert pcity.load_cityscapes_semantic(img, gt) == \
            jcity.load_cityscapes_semantic(img, gt)
    annos = [a for r in got for a in r["annotations"]]
    assert {a["iscrowd"] for a in annos} <= {0, 1}
    names = {}
    for pkg, mod in ((pdata, pcity), (jdata, jcity)):
        before = set(pkg.DatasetCatalog.list())
        mod.register_all_cityscapes(str(tmp_path))
        names[pkg] = set(pkg.DatasetCatalog.list()) - before
    assert names[pdata] == names[jdata] and len(names[pdata]) == 6
    for name in ("cityscapes_fine_instance_seg_train",
                 "cityscapes_fine_sem_seg_val"):
        assert pdata.DatasetCatalog.get(name) == \
            jdata.DatasetCatalog.get(name)
    for name in names[pdata]:
        for key in ("thing_classes", "image_dir", "gt_dir",
                    "evaluator_type"):
            assert pdata.MetadataCatalog.get(name).get(key) == \
                jdata.MetadataCatalog.get(name).get(key)


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_same(got[k], w)
        else:
            g = got[k]
            assert (np.isnan(g) and np.isnan(w)) or g == w, (k, g, w)


def _lvis_dets(records, n_cls, rs):
    """Per image: jittered copies of its GT, and detections of random
    classes (those listed negative or not exhaustive among them)."""
    out = {}
    for r in records:
        boxes, classes = [], []
        for a in r["annotations"]:
            boxes.append(np.asarray(a["bbox"]) + rs.uniform(-3, 3, 4))
            classes.append(a["category_id"])
        for c in r["neg_category_ids"] + r["not_exhaustive_category_ids"] + \
                list(rs.randint(0, n_cls, 3)):
            x, y = rs.uniform(0, 30, 2)
            boxes.append([x, y, x + rs.uniform(4, 30), y + rs.uniform(4, 30)])
            classes.append(int(c))
        n = len(boxes)
        out[str(r["image_id"])] = (np.asarray(boxes, np.float32),
                                   rs.uniform(0, 1, n).astype(np.float32),
                                   np.asarray(classes), rs.uniform(0, 1, n) > 0.1)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lvis_evaluator_bit_equal_to_jax(tmp_path, seed):
    jf = str(tmp_path / "lvis.json")
    data = write_lvis_json(jf, n_images=8, seed=seed)
    records = plvis.load_lvis_json(jf, "/imgs")
    cats = sorted(data["categories"], key=lambda c: c["id"])
    names = [c["name"] for c in cats]
    freq = [c.get("frequency", "f") for c in cats]
    gt = {str(r["image_id"]): r["annotations"] for r in records}
    info = {str(r["image_id"]): {
        "neg_category_ids": r["neg_category_ids"],
        "not_exhaustive_category_ids": r["not_exhaustive_category_ids"]}
        for r in records}
    dets = _lvis_dets(records, len(names), np.random.RandomState(seed))
    evs = [plveval.LVISDetectionEvaluator(names, gt, info, freq),
           jlveval.LVISDetectionEvaluator(names, gt, info, freq)]
    for ev in evs:
        for image_id, d in dets.items():
            ev.process_single(image_id, *d)
    got, want = evs[0].evaluate(), evs[1].evaluate()
    _assert_same(got, want)
    assert set(got) == {"AP", "AP50", "AP75", "APr", "APc", "APf"}
    assert np.isfinite(got["AP"])

    # two halves merged give the whole
    halves = [plveval.LVISDetectionEvaluator(names, gt, info, freq)
              for _ in range(2)]
    for k, (image_id, d) in enumerate(dets.items()):
        halves[k % 2].process_single(image_id, *d)
    merged = plveval.LVISDetectionEvaluator(names, gt, info, freq)
    merged.merge_states([h.state_dict() for h in halves])
    _assert_same(merged.evaluate(), want)
    # without frequencies: no APr/APc/APf, as in the JAX package
    bare = [plveval.LVISDetectionEvaluator(names, gt, info),
            jlveval.LVISDetectionEvaluator(names, gt, info)]
    for ev in bare:
        ev.merge_states([evs[0].state_dict()])
    _assert_same(bare[0].evaluate(), bare[1].evaluate())
    assert set(bare[0].evaluate()) == {"AP", "AP50", "AP75"}


def _city_instances(rs, n_images=4, h=40, w=52):
    gt, dets = {}, {}
    for i in range(n_images):
        annos = []
        for j in range(rs.randint(1, 5)):
            poly = _poly(rs, w, h)
            annos.append({"category_id": int(rs.randint(0, 3)),
                          "bbox": [0, 0, 1, 1],
                          "iscrowd": int(j == 2),
                          "segmentation": [[c for p in poly for c in p]]})
        if i == 1:   # an RLE crowd region and an empty segmentation
            annos.append({"category_id": 0, "iscrowd": 1,
                          "segmentation": {"size": [h, w],
                                           "counts": [100, 60, 300, 80]}})
            annos.append({"category_id": 1, "segmentation": []})
        gt[f"img{i}"] = annos
        n = rs.randint(2, 7)
        masks = np.zeros((n, h, w), np.uint8)
        for d in range(n):
            y, x = rs.randint(0, h - 6), rs.randint(0, w - 6)
            masks[d, y:y + rs.randint(4, h - y), x:x + rs.randint(4, w - x)] = 1
        dets[f"img{i}"] = (np.zeros((n, 4), np.float32),
                           rs.uniform(0, 1, n).astype(np.float32),
                           rs.randint(0, 4, n), rs.uniform(0, 1, n) > 0.15,
                           masks)
    return gt, dets


@pytest.mark.parametrize("seed", [0, 1])
def test_cityscapes_instance_evaluator_bit_equal_to_jax(seed):
    gt, dets = _city_instances(np.random.RandomState(seed))
    names = ["person", "rider", "car", "truck"]
    evs = [pceval.CityscapesInstanceEvaluator(names, gt),
           jceval.CityscapesInstanceEvaluator(names, gt)]
    for ev in evs:
        for image_id, (b, s, c, v, m) in dets.items():
            ev.process_single(image_id, b, s, c, v, masks=m)
        ev.process_single("img0", *dets["img0"][:4])   # no masks: nothing
    got, want = evs[0].evaluate(), evs[1].evaluate()
    _assert_same(got, want)
    assert set(got["segm"]) == {"AP", "AP50"}
    halves = [pceval.CityscapesInstanceEvaluator(names, gt)
              for _ in range(2)]
    for k, (image_id, (b, s, c, v, m)) in enumerate(dets.items()):
        halves[k % 2].process_single(image_id, b, s, c, v, masks=m)
    merged = pceval.CityscapesInstanceEvaluator(names, gt)
    merged.merge_states([h.state_dict() for h in halves])
    _assert_same(merged.evaluate(), want)


@pytest.mark.parametrize("train_ids", [False, True])
def test_cityscapes_sem_seg_evaluator_bit_equal_to_jax(train_ids):
    rs = np.random.RandomState(7)
    label_map = rs.randint(-2, 40, (37, 29))
    assert (pceval.label_ids_to_train_ids(label_map) ==
            jceval.label_ids_to_train_ids(label_map)).all()
    assert pceval.CITYSCAPES_SEM_SEG_CLASSES == \
        jceval.CITYSCAPES_SEM_SEG_CLASSES
    evs = [pceval.CityscapesSemSegEvaluator(train_ids),
           jceval.CityscapesSemSegEvaluator(train_ids)]
    for _ in range(3):
        pred = rs.randint(0, 19, (37, 29))
        gt = rs.randint(0, 34, (37, 29))
        if train_ids:
            gt = np.where(rs.uniform(size=gt.shape) < 0.1, 255, gt % 19)
        for ev in evs:
            ev.process_single(pred, gt)
    _assert_same(evs[0].evaluate(), evs[1].evaluate())
    assert len([k for k in evs[0].evaluate()["sem_seg"]
                if k.startswith("IoU-")]) == 19


def test_build_evaluator_types(tmp_path, clean_catalogs):
    """The four arms of JAX ``tools/train_net.py:build_evaluator``, the
    LVIS one with each record's negative and not-exhaustive classes."""
    jf = str(tmp_path / "lvis.json")
    write_lvis_json(jf, seed=4)
    plvis.register_lvis_instances("p_bev_lvis", jf, str(tmp_path))
    records = pdata.DatasetCatalog.get("p_bev_lvis")
    _, pc = cfg_pair(*TOY)
    ev = train_net.build_evaluator(pc, "p_bev_lvis", records)
    assert isinstance(ev, plveval.LVISDetectionEvaluator)
    assert ev._info[str(records[0]["image_id"])] == {
        "neg_category_ids": records[0]["neg_category_ids"],
        "not_exhaustive_category_ids":
            records[0]["not_exhaustive_category_ids"]}
    assert ev._freq == pdata.MetadataCatalog.get("p_bev_lvis") \
        .thing_frequencies
    write_cityscapes(tmp_path, seed=1)
    pcity.register_all_cityscapes(str(tmp_path))
    mask_on = pc.clone()
    mask_on.MODEL.MASK_ON = True
    name = "cityscapes_fine_instance_seg_val"
    recs = pdata.DatasetCatalog.get(name)
    assert isinstance(train_net.build_evaluator(mask_on, name, recs),
                      pceval.CityscapesInstanceEvaluator)
    assert isinstance(train_net.build_evaluator(
        pc, "cityscapes_fine_sem_seg_val", []),
        pceval.CityscapesSemSegEvaluator)
    from drn_wsod_torch.evaluation import RotatedCOCODetectionEvaluator

    pdata.MetadataCatalog.get("p_bev_rot").set(evaluator_type="rotated_coco",
                                               thing_classes=["a", "b"])
    assert isinstance(train_net.build_evaluator(pc, "p_bev_rot", []),
                      RotatedCOCODetectionEvaluator)


def write_lvis_split(root, name, n_images, seed, n_props=90):
    """An LVIS split: the json, one JPEG an image and a proposals pickle
    keyed by the integer image ids. Returns (json, image dir,
    proposals)."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    image_dir = root / name
    image_dir.mkdir(parents=True)
    jf = str(root / f"{name}.json")
    data = write_lvis_json(jf, n_images=n_images, seed=seed)
    props = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
    for k, img in enumerate(data["images"]):
        h, w = img["height"], img["width"]
        base = rs.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(
            np.uint8)
        Image.fromarray(base).resize((w, h), Image.BILINEAR).save(
            image_dir / f"{k:012d}.jpg", quality=90)
        x1 = rs.randint(0, w - 8, n_props).astype(np.float32)
        y1 = rs.randint(0, h - 8, n_props).astype(np.float32)
        x2 = np.minimum(x1 + rs.randint(4, w, n_props), w - 1)
        y2 = np.minimum(y1 + rs.randint(4, h, n_props), h - 1)
        props["ids"].append(img["id"])
        props["boxes"].append(np.stack([x1, y1, x2, y2], 1).astype(
            np.float32))
        props["objectness_logits"].append(
            rs.uniform(-2, 2, n_props).astype(np.float32))
    prop_file = str(root / f"{name}_props.pkl")
    with open(prop_file, "wb") as f:
        pickle.dump(props, f)
    return jf, str(image_dir), prop_file, data


def test_lvis_do_test_matches_jax(tmp_path, clean_catalogs, monkeypatch):
    import jax

    from drn_wsod_tpu.checkpoint import torch_import as jimport
    from drn_wsod_tpu.engine.defaults import _init_variables

    name = "torch_lvis_do_test"
    jf, image_dir, prop_file, data = write_lvis_split(tmp_path, "val", 4, 9)
    for mod in (plvis, jlvis):
        mod.register_lvis_instances(name, jf, image_dir)
    for pkg in (pdata, jdata):
        pkg.DatasetCatalog.get(name)   # the metadata is set on load
    n_cls = len(data["categories"])
    jc, pc = cfg_pair(
        *TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
        "MODEL.ROI_HEADS.NUM_CLASSES", n_cls,
        "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 90,
        "INPUT.BUCKETS", [96], "TEST.AUG.ENABLED", False,
        "TEST.EVAL_TRAIN", False, "TEST.DETECTIONS_PER_IMAGE", TOPK,
        "DATASETS.TEST", (name,), "DATASETS.PROPOSAL_FILES_TEST",
        (prop_file,), "DATALOADER.NUM_WORKERS", 0,
        "PARALLEL.MESH_SHAPE", [1], yaml=COCO_YAML)
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    batch = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, n_cls, seed=3,
                                           device="cpu")
    sd = drn_wsod_torch.params_from_jax(random_params(param_shapes(
        lambda: jm.init({"params": key, "dropout": key}, jax_batch(batch),
                        train=False)), seed=5))
    weights = tmp_path / "model.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": d2_state_dict(sd)}, f)
    jc.MODEL.WEIGHTS = pc.MODEL.WEIGHTS = str(weights)
    variables = jimport.load_reference_weights(jc.MODEL.WEIGHTS,
                                               _init_variables(jm, jc))
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    drn_wsod_torch.load_reference_weights(pc.MODEL.WEIGHTS, pm)

    dets = {}
    for tag, cls in (("p", plveval.LVISDetectionEvaluator),
                     ("j", jlveval.LVISDetectionEvaluator)):
        process = cls.process_single

        def recording(self, image_id, boxes, scores, classes, valid,
                      _t=tag, _p=process):
            dets.setdefault(_t, {})[image_id] = {
                "boxes": np.asarray(boxes), "scores": np.asarray(scores),
                "classes": np.asarray(classes), "valid": np.asarray(valid)}
            return _p(self, image_id, boxes, scores, classes, valid)

        monkeypatch.setattr(cls, "process_single", recording)
    got = train_net.do_test(pc, pm, device="cpu")[name]
    want = _jax_train_net().do_test(jc, jm, variables)[name]
    assert dets["p"].keys() == dets["j"].keys() and len(dets["p"]) == 4
    for image_id, d in dets["p"].items():
        assert_detections_match(d, dets["j"][image_id], RTOL, ATOL, TOPK)
    assert got.keys() == want.keys() >= {"AP", "APr", "APc", "APf"}
    for k, w in want.items():
        g = got[k]
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-6, (k, g, w)
    records = pdata.DatasetCatalog.get(name)
    ev = train_net.build_evaluator(pc, name, records)
    for image_id, d in dets["j"].items():
        ev.process_single(image_id, d["boxes"], d["scores"], d["classes"],
                          d["valid"])
    _assert_same(ev.evaluate(), want)
