"""The port's training entry point on the dense YAMLs against the JAX
package's ``tools/train_net.py`` (loaded by path), on the CPU:
``quick_schedules/retinanet_R_50_instant_test``, ``Misc/
semantic_R_50_FPN_1x`` and ``Misc/panoptic_fpn_R_50_1x`` at a toy size
(R18-FPN 16, 64-96 pixel images in one 96 bucket, two images a batch,
float32, the semantic heads 16 wide, PanopticFPN's mask pool at 4 x 4),
both models built holding the same numpy weights.

The data: the PNG fixtures' COCO panoptic-separated tree
(``drn_wsod_torch/data/png_fixtures/panoptic``: 80 thing and 53 stuff
classes, label and panoptic PNGs) loaded by each package's
``load_coco_panoptic_separated``, each record given random pixels (the
packed-record path), registered in both packages: its train split to
train on, its val split as "coco" for RetinaNet, "sem_seg" for the
semantic model (the YAML's own "coco_panoptic_seg" split needs
instances, which a SemanticSegmentor does not give: both CLIs stop
there, ``test_semantic_on_a_panoptic_split_stops``) and
"coco_panoptic_seg" for PanopticFPN, which trains and tests with a
proposal file (40 an image, some near the GT: the 64 slots take every
proposal whatever the sampler's keys).

``do_train``, 3 steps: each step's losses within rtol 1e-4 and atol 1e-5;
RetinaNet, with one square anchor of a power-of-two size a cell (exact
anchor corners, so that anchors tied at a GT's best IoU tie in both
packages), only on the steps where no GT has an anchor within 1e-5 of
the matcher's 0.4 and 0.5 or two best anchors within 1e-5 but untied
(the two packages' IoUs may round either way there;
``tests/test_torch_retinanet.py``), at least one step. Then ``do_test``
from the same weights: the same tasks (COCO box AP; mIoU; box and segm AP
and PQ), each metric within 0.05 (percent: an argmax between two scores
within 1e-6 may differ).
"""

import json
import pickle

import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch import data as pdata
from drn_wsod_torch.data.datasets import coco as pcoco
from drn_wsod_torch.models.proposal_generator import generate_anchors
from drn_wsod_torch.structures.boxes import pairwise_iou
from drn_wsod_torch.tools import make_png_fixtures as fx
from drn_wsod_torch.tools import train_net
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import coco as jcoco
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (CONFIGS, cfg_pair, jax_batch, param_shapes,
                               random_params)
from test_torch_mask_rcnn import _dense_batch
from test_torch_mask_train_net import _same_start
from test_torch_train_net import (_jax_train, _jax_train_net, _port_train,
                                  _with)

torch.set_num_threads(1)

ROOT = fx.FIXTURE_DIR / "panoptic"
YAMLS = {"retinanet": "quick_schedules/retinanet_R_50_instant_test.yaml",
         "semantic": "Misc/semantic_R_50_FPN_1x.yaml",
         "panoptic": "Misc/panoptic_fpn_R_50_1x.yaml"}
TEST_TYPE = {"retinanet": "coco", "semantic": "sem_seg",
             "panoptic": "coco_panoptic_seg"}
NAMES = {"loss_cls", "loss_box_reg", "loss_sem_seg", "loss_mask",
         "total_loss"}
LOSSES = {"retinanet": {"loss_cls", "loss_box_reg", "total_loss"},
          "semantic": {"loss_sem_seg", "total_loss"},
          "panoptic": NAMES}


def _split(split: str, seed: int):
    """Each package's records of a split of the tree with the same random
    pixels, and a proposals pickle (40 an image, a few near its GT)."""
    args = (str(ROOT / "annotations" / f"panoptic_{split}.json"), str(ROOT),
            str(ROOT / f"panoptic_{split}"),
            str(ROOT / f"panoptic_stuff_{split}"),
            str(ROOT / "annotations" / f"instances_{split}.json"))
    p = pcoco.load_coco_panoptic_separated(*args)
    j = jcoco.load_coco_panoptic_separated(*args)
    assert p == j
    rs = np.random.RandomState(seed)
    props = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
    for pr, jr in zip(p, j):
        h, w = pr["height"], pr["width"]
        pr["image"] = jr["image"] = rs.randint(0, 256, (h, w, 3), np.uint8)
        x1 = rs.uniform(0, w - 60, 40)
        y1 = rs.uniform(0, h - 60, 40)
        boxes = np.stack([x1, y1, np.minimum(x1 + rs.uniform(50, w, 40),
                                             w - 1),
                          np.minimum(y1 + rs.uniform(50, h, 40), h - 1)], 1)
        gt = np.asarray([a["bbox"] for a in pr["annotations"]
                         if not a["iscrowd"]])
        if len(gt):
            near = rs.rand(40) < 0.12
            boxes[near] = gt[rs.randint(len(gt), size=near.sum())] + \
                rs.uniform(-8, 8, (near.sum(), 4))
        props["ids"].append(pr["image_id"])
        props["boxes"].append(np.clip(boxes, 0, [w - 1, h - 1, w - 1, h - 1])
                              .astype(np.float32))
        props["objectness_logits"].append(
            rs.uniform(-2, 2, 40).astype(np.float32))
    return p, j, props


@pytest.fixture(scope="module")
def jtn():
    return _jax_train_net()


@pytest.fixture(scope="module", params=sorted(YAMLS))
def setup(request, tmp_path_factory):
    case = request.param
    root = tmp_path_factory.mktemp(f"dense_tn_{case}")
    train, test = f"torch_dense_{case}_train", f"torch_dense_{case}_test"
    (ptr, jtr, prop_tr), (pte, jte, prop_te) = (_split("train2017", 1),
                                                 _split("val2017", 2))
    files = []
    for name, props in (("train", prop_tr), ("test", prop_te)):
        files.append(str(root / f"{name}_props.pkl"))
        with open(files[-1], "wb") as f:
            pickle.dump(props, f)
    meta = json.loads((ROOT / "annotations" / "panoptic_val2017.json")
                      .read_text())
    stuff = ["things"] + [c["name"] for c in meta["categories"]
                          if not c["isthing"]]
    things = [f"class{c}" for c in range(1, 81)]
    for pkg, tr, te in ((pdata, ptr, pte), (jdata, jtr, jte)):
        pkg.DatasetCatalog.register(train, lambda r=tr: r)
        pkg.DatasetCatalog.register(test, lambda r=te: r)
        for name in (train, test):
            pkg.MetadataCatalog.get(name).set(
                thing_classes=things, stuff_classes=stuff,
                evaluator_type=TEST_TYPE[case] if name == test else "coco")
    opts = ["MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
            "MODEL.FPN.OUT_CHANNELS", 16, "MODEL.DTYPE", "float32",
            "MODEL.PIXEL_STD", [57.4, 57.1, 58.4], "MODEL.WEIGHTS", "",
            "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16,
            "MODEL.ROI_HEADS.NUM_CLASSES", 80,
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
            "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 4,
            "MODEL.PROPOSAL_GENERATOR.MIN_SIZE", 2,
            "MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT", 64,
            "DATASETS.MAX_GT_PER_IMAGE", 8,
            "INPUT.MIN_SIZE_TRAIN", (48, 64), "INPUT.MAX_SIZE_TRAIN", 90,
            "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 90,
            "INPUT.BUCKETS", [96], "SOLVER.IMS_PER_BATCH", 2,
            "SOLVER.BASE_LR", 0.002, "SOLVER.MAX_ITER", 3,
            "SOLVER.CHECKPOINT_PERIOD", 3, "SOLVER.STEPS_PER_DISPATCH", 1,
            "SEED", 0, "TEST.EVAL_PERIOD", 0, "TEST.EVAL_TRAIN", False,
            "TEST.DETECTIONS_PER_IMAGE", 8,
            "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 1e-5,
            "DATASETS.TRAIN", (train,), "DATASETS.TEST", (test,),
            "DATALOADER.NUM_WORKERS", 0, "PARALLEL.MESH_SHAPE", [1]]
    if case == "retinanet":
        # one square anchor a cell, of a power-of-two size: every anchor's
        # corners and area are exact, so anchors tied at a GT's best IoU
        # are tied in both packages' rounding
        opts += ["MODEL.ANCHOR_GENERATOR.SIZES", [[16.0], [32.0], [64.0],
                                                  [128.0]],
                 "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS", [[1.0]]]
    if case == "panoptic":
        opts += ["DATASETS.PROPOSAL_FILES_TRAIN", (files[0],),
                 "DATASETS.PROPOSAL_FILES_TEST", (files[1],)]
    else:
        opts += ["MODEL.LOAD_PROPOSALS", False]
    jc, pc = cfg_pair(*opts, yaml=str(CONFIGS / YAMLS[case]))
    jm = jax_build_model(jc)
    b = _dense_batch(0).replace(sem_seg=torch.zeros(2, 64, 64,
                                                    dtype=torch.int32))
    import jax
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(b), train=True)), seed=3)
    yield case, root, jc, pc, test, flat
    for pkg in (pdata, jdata):
        pkg.DatasetCatalog.remove(train)
        pkg.DatasetCatalog.remove(test)


def _tie_free(batch, pm) -> bool:
    """Whether no valid GT box of the batch has an anchor within 1e-5 of
    the matcher's 0.4 or 0.5, nor two best anchors apart by less than
    1e-5 but not tied."""
    H, W = batch.image.shape[1:3]
    anchors = torch.cat([generate_anchors(
        (-(-H // s), -(-W // s)), s, sz, pm.aspect_ratios)
        for s, sz in zip(pm.strides, pm.anchor_sizes)])
    for gb, gv in zip(batch.gt_boxes, batch.gt_valid):
        iou = pairwise_iou(gb[gv], anchors)
        if not len(iou):
            continue
        top2 = iou.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        if ((gap > 0) & (gap <= 1e-5)).any() or min(
                (iou - t).abs().min() for t in (0.4, 0.5)) <= 1e-5:
            return False
    return True


def _small_mask_pool(monkeypatch):
    """PanopticFPN's mask pool at 4 x 4 in both packages (14, fixed in
    both builders, puts the 4 x 256 mask head on 14^2 cells of every slot
    and takes most of the test's time)."""
    import test_torch_train_net

    build = test_torch_train_net.jax_build_model
    monkeypatch.setattr(test_torch_train_net, "jax_build_model",
                        lambda cfg: _jax_model(cfg, build))
    port_build = drn_wsod_torch.build_model

    def building(cfg, device=None):
        model = port_build(cfg, device=device)
        if hasattr(model, "mask_pooler_resolution"):
            model.mask_pooler_resolution = 4
        return model
    monkeypatch.setattr(drn_wsod_torch, "build_model", building)


def _jax_model(cfg, build=jax_build_model):
    model = build(cfg)
    if cfg.MODEL.META_ARCHITECTURE == "PanopticFPN":
        model = model.clone(mask_pooler_resolution=4)
    return model


def test_do_train_matches_jax(setup, jtn, monkeypatch):
    case, root, jc, pc, _, flat = setup
    _same_start(monkeypatch, jtn, flat)
    _small_mask_pool(monkeypatch)
    batches = []
    from drn_wsod_torch.engine import trainer as ptrainer
    make = ptrainer.make_train_step

    def keeping(*a, **k):
        fn = make(*a, **k)

        def step(state, batch, seed):
            batches.append(batch)
            return fn(state, batch, seed)
        return step
    monkeypatch.setattr(ptrainer, "make_train_step", keeping)
    _, want = _jax_train(jtn, _with(jc, OUTPUT_DIR=str(root / "jax")),
                         monkeypatch)
    trainer, got, _ = _port_train(_with(pc, OUTPUT_DIR=str(root / "port")),
                                  monkeypatch)
    assert trainer.state.step == 3 and len(got) == len(want) == 3
    compared = 0
    for b, g, w in zip(batches, got, want):
        assert g.keys() == w.keys() == LOSSES[case]
        assert all(np.isfinite(v) for v in g.values())
        if case == "retinanet" and not _tie_free(b, trainer.state.model):
            continue
        compared += 1
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
    assert compared >= 1
    if case == "panoptic":
        assert all(m["loss_mask"] > 0 and m["loss_box_reg"] > 0
                   for m in want)


def _close(got, want, atol=0.05):
    assert got.keys() == want.keys()
    for task, metrics in want.items():
        for k, w in metrics.items():
            g = got[task][k]
            assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= atol, (
                task, k, g, w)


def test_do_test_matches_jax(setup, jtn, monkeypatch):
    case, _, jc, pc, test, flat = setup
    _same_start(monkeypatch, jtn, flat)
    _small_mask_pool(monkeypatch)
    import jax

    from test_torch_common import unflatten
    jm = _jax_model(jc)
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    got = train_net.do_test(pc, pm, device="cpu")[test]
    want = jtn.do_test(jc, jm, {"params": unflatten(flat)})[test]
    jax.clear_caches()
    tasks = {"retinanet": ["bbox"], "semantic": ["sem_seg"],
             "panoptic": ["bbox", "segm", "panoptic_seg"]}[case]
    assert list(got) == tasks == list(want)
    _close(got, want)


def test_semantic_on_a_panoptic_split_stops(jtn):
    """The semantic YAML's own test split is "coco_panoptic_seg": its
    evaluation asks for instances, which neither package's
    SemanticSegmentor gives (the JAX CLI fails on the missing
    ``inference_scores``; the port says why)."""
    import jax

    from test_torch_common import unflatten

    name = "torch_dense_semantic_on_panoptic"
    p, j, _ = _split("val2017", 4)
    for pkg, records in ((pdata, p), (jdata, j)):
        pkg.DatasetCatalog.register(name, lambda r=records: r)
        pkg.MetadataCatalog.get(name).set(
            thing_classes=[f"class{c}" for c in range(1, 81)],
            evaluator_type="coco_panoptic_seg")
    try:
        jc, pc = cfg_pair("MODEL.RESNETS.DEPTH", 18,
                          "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
                          "MODEL.FPN.OUT_CHANNELS", 16,
                          "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16,
                          "MODEL.DTYPE", "float32", "INPUT.MIN_SIZE_TEST",
                          64, "INPUT.MAX_SIZE_TEST", 90, "INPUT.BUCKETS",
                          [96], "DATASETS.TEST", (name,),
                          "MODEL.ROI_HEADS.NUM_CLASSES", 80,
                          yaml=str(CONFIGS / YAMLS["semantic"]))
        pm = drn_wsod_torch.build_model(pc, device="cpu")
        with pytest.raises(ValueError, match="detects no instances"):
            train_net.do_test(pc, pm, device="cpu")
        jm = jax_build_model(jc)
        b = _dense_batch(0).replace(sem_seg=torch.zeros(2, 64, 64,
                                                        dtype=torch.int32))
        key = jax.random.PRNGKey(0)
        flat = random_params(param_shapes(lambda: jm.init(
            {"params": key}, jax_batch(b))), seed=3)
        with pytest.raises(AttributeError, match="inference_scores"):
            jtn.do_test(jc, jm, {"params": unflatten(flat)})
    finally:
        for pkg in (pdata, jdata):
            pkg.DatasetCatalog.remove(name)
