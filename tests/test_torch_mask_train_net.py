"""The port's training entry point on the Mask R-CNN YAML and its Keypoint
R-CNN variant, against the JAX package's ``tools/train_net.py`` on the
CPU.

The data: COCO instances jsons of ``drn_wsod_torch/tools/
make_mask_fixtures.py:synthetic_coco`` (COCO-sized JPEGs; polygon masks,
some of two polygons, a crowd region as RLE, an image without
annotations; or people with 17 keypoints, some with none labelled) and a
proposals pickle keyed by the integer image ids, registered in both
packages. The config: ``Misc/mask_rcnn_R_50_FPN_1x.yaml`` at a toy size
(R18-FPN with 16 channels, DAN [64, 64], P = 64, float32, dropout 0, the
mask and keypoint pools at 4 x 4, 64-pixel images in one 96 bucket, two
images a batch, proposals down to 2 pixels kept); for keypoints ``MASK_ON False``, ``KEYPOINT_ON True`` and
one class, as Detectron2's ``keypoint_rcnn_R_50_FPN_1x.yaml`` sets them.
Both packages load one Detectron2 ``.pkl`` written from numpy weights
(the transposed convs in the JAX import's layout: see
``tests/test_torch_masks.py``). Neither import reaches the FPN's convs
(``tests/test_torch_item14_import.py``), so both models are built holding
those numpy weights already.

The JAX package's ``do_train`` cannot build the supervised heads as it
stands: ``engine/defaults.py:_init_variables`` initialises the model on a
batch without instance GT, and Fast R-CNN's sampler needs it (and the
mask and keypoint heads exist only where the batch has their GT). The
test gives that initialisation a batch with the GT; every value it draws
is then replaced by the checkpoint's (ROADMAP.md section 3).

``do_train`` for 3 steps: each step's losses (``loss_mask`` or
``loss_keypoint`` among them) within rtol 1e-4 and atol 1e-5. Then
``do_test`` through the test loader from the same weights: each image's
detections as in ``tests/test_torch_eval_slice.py``, the mask
probabilities within the same tolerance, the pasted masks equal, the
COCO metrics (bbox, and segm or keypoints) to 1e-6, and the port's
evaluator on the JAX package's own detections, masks and keypoints
bit-equal to the JAX evaluator.
"""

import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import drn_wsod_torch
from drn_wsod_torch import data as pdata
from drn_wsod_torch.data.datasets import coco as pcoco
from drn_wsod_torch.evaluation import coco_eval as pcoco_eval
from drn_wsod_torch.evaluation import evaluator as pevaluator
from drn_wsod_torch.tools import train_net
from drn_wsod_torch.tools.make_mask_fixtures import synthetic_coco
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import coco as jcoco
from drn_wsod_tpu.evaluation import coco_eval as jcoco_eval
from drn_wsod_tpu.evaluation import evaluator as jevaluator
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_mask_rcnn import _dense_batch
from test_torch_common import (CONFIGS, TOY, assert_detections_match,
                               cfg_pair, d2_state_dict, jax_batch,
                               param_shapes, random_params, unflatten)
from test_torch_train_net import (_assert_losses_close, _jax_train,
                                  _jax_train_net, _port_train, _with)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
MASK_YAML = str(CONFIGS / "Misc" / "mask_rcnn_R_50_FPN_1x.yaml")
TOPK = 4
# Detectron2's COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml: person only
KEYPOINT = ("MODEL.MASK_ON", False, "MODEL.KEYPOINT_ON", True,
            "MODEL.ROI_HEADS.NUM_CLASSES", 1)


def write_split(root, name, seed, n_images, keypoints, first_id, n_props=40):
    """A COCO split of ``synthetic_coco``: the json, one JPEG an image and
    a proposals pickle of 40 proposals an image, about 5 of them near a GT
    box. The sampler's 64 slots hold 16 foreground and 48 background, so
    every proposal is sampled whatever the keys (the two packages draw
    different keys) and only the slots' order differs."""
    rs = np.random.RandomState(seed)
    coco = synthetic_coco(seed, n_images, first_id=first_id,
                          keypoints=keypoints)
    image_dir = root / name
    image_dir.mkdir(parents=True)
    jf = root / f"{name}.json"
    jf.write_text(__import__("json").dumps(coco))
    props = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
    by_image = {}
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        by_image.setdefault(a["image_id"], []).append([x, y, x + w, y + h])
    for img in coco["images"]:
        h, w = img["height"], img["width"]
        base = rs.randint(0, 256, (h // 32 + 1, w // 32 + 1, 3)).astype(
            np.uint8)
        Image.fromarray(base).resize((w, h), Image.BILINEAR).save(
            image_dir / img["file_name"], quality=90)
        x1 = rs.uniform(0, w - 40, n_props)
        y1 = rs.uniform(0, h - 40, n_props)
        boxes = np.stack([x1, y1, np.minimum(x1 + rs.uniform(30, w, n_props),
                                             w - 1),
                          np.minimum(y1 + rs.uniform(30, h, n_props), h - 1)],
                         1)
        gt = np.asarray(by_image.get(img["id"], []))
        if len(gt):
            near = rs.rand(n_props) < 0.12
            boxes[near] = gt[rs.randint(len(gt), size=near.sum())] + \
                rs.uniform(-6, 6, (near.sum(), 4))
        props["ids"].append(img["id"])
        props["boxes"].append(np.clip(boxes, 0, [w - 1, h - 1, w - 1, h - 1])
                              .astype(np.float32))
        props["objectness_logits"].append(
            rs.uniform(-2, 2, n_props).astype(np.float32))
    prop_file = root / f"{name}_props.pkl"
    with open(prop_file, "wb") as f:
        pickle.dump(props, f)
    return str(jf), str(image_dir), str(prop_file)


def _flax_weights(jc):
    """Numpy weights under the flax names of the config's model."""
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    return random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(_dense_batch(0)),
        train=True)), seed=4)


def _d2_weights(path, flat):
    """A Detectron2 .pkl of the weights ``flat`` (the heads under
    ``roi_heads.``): every conv OIHW but the transposed convs, which are
    written as the JAX import reads them, so that both packages load the
    same flax kernel."""
    sd = drn_wsod_torch.params_from_jax(flat)
    d2 = d2_state_dict(sd)
    for name, v in flat.items():
        if name.endswith(("deconv.kernel", "score_lowres.kernel")):
            # the JAX import turns a D2 weight with (2, 3, 1, 0)
            d2.pop(name.replace(".kernel", ".weight"))
            d2["roi_heads." + name.replace(".kernel", ".weight")] = \
                np.ascontiguousarray(v.transpose(3, 2, 0, 1))
    for k in list(d2):
        if k.startswith(("mask_head.", "keypoint_head.")):
            d2["roi_heads." + k] = d2.pop(k)
    with open(path, "wb") as f:
        pickle.dump({"model": d2}, f)
    return str(path)


CASES = {"mask": (), "keypoint": KEYPOINT}


@pytest.fixture(scope="module")
def jtn():
    return _jax_train_net()


@pytest.fixture(scope="module", params=sorted(CASES))
def setup(request, tmp_path_factory):
    case = request.param
    keypoints = case == "keypoint"
    root = tmp_path_factory.mktemp(f"mask_train_net_{case}")
    train_name, test_name = f"torch_{case}_tn_train", f"torch_{case}_tn_test"
    train = write_split(root, "train", 51, 6, keypoints, 1)
    test = write_split(root, "test", 52, 3, keypoints, 101)
    for reg in (pcoco.register_coco_instances, jcoco.register_coco_instances):
        reg(train_name, train[0], train[1])
        reg(test_name, test[0], test[1])
    for pkg in (pdata, jdata):
        pkg.DatasetCatalog.get(train_name)
        pkg.DatasetCatalog.get(test_name)
    opts = (*TOY, "MODEL.FPN.OUT_CHANNELS", 16,
            "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
            "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0,
            "MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", 4,
            "MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION", 4,
            "MODEL.PROPOSAL_GENERATOR.MIN_SIZE", 2,
            "INPUT.MIN_SIZE_TRAIN", (48, 64), "INPUT.MAX_SIZE_TRAIN", 90,
            "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 90,
            "INPUT.BUCKETS", [96], "SOLVER.IMS_PER_BATCH", 2,
            "SOLVER.BASE_LR", 0.002,
            "SOLVER.MAX_ITER", 3, "SOLVER.CHECKPOINT_PERIOD", 2,
            "SOLVER.STEPS_PER_DISPATCH", 1, "SEED", 0,
            "TEST.EVAL_PERIOD", 0, "TEST.EVAL_TRAIN", False,
            "TEST.DETECTIONS_PER_IMAGE", TOPK,
            "MODEL.ROI_HEADS.SCORE_THRESH_TEST", 1e-5,
            "DATASETS.TRAIN", (train_name,), "DATASETS.TEST", (test_name,),
            "DATASETS.PROPOSAL_FILES_TRAIN", (train[2],),
            "DATASETS.PROPOSAL_FILES_TEST", (test[2],),
            "DATALOADER.NUM_WORKERS", 0, "PARALLEL.MESH_SHAPE", [1],
            *CASES[case])
    jc, pc = cfg_pair(*opts, yaml=MASK_YAML)
    flat = _flax_weights(jc)
    jc.MODEL.WEIGHTS = pc.MODEL.WEIGHTS = _d2_weights(root / "weights.pkl",
                                                      flat)
    yield case, root, jc, pc, test_name, flat
    for pkg in (pdata, jdata):
        pkg.DatasetCatalog.remove(train_name)
        pkg.DatasetCatalog.remove(test_name)


def _same_start(monkeypatch, jtn, flat):
    """Both packages' models built holding ``flat``: the JAX package's
    initialisation returns it (it would need a batch with GT to run), the
    port's ``build_model`` loads it."""
    monkeypatch.setattr(jtn, "_init_variables",
                        lambda model, cfg, batch=None:
                        {"params": unflatten(flat)})
    build = drn_wsod_torch.build_model

    def building(cfg, device=None):
        model = build(cfg, device=device)
        model.load_state_dict(drn_wsod_torch.params_from_jax(flat),
                              strict=True)
        return model
    monkeypatch.setattr(drn_wsod_torch, "build_model", building)


def test_do_train_matches_jax(setup, jtn, monkeypatch):
    case, root, jc, pc, _, flat = setup
    _same_start(monkeypatch, jtn, flat)
    jc3 = _with(jc, OUTPUT_DIR=str(root / "out" / "jax"))
    pc3 = _with(pc, OUTPUT_DIR=str(root / "out" / "port"))
    _, want = _jax_train(jtn, jc3, monkeypatch)
    trainer, got, _ = _port_train(pc3, monkeypatch)
    assert trainer.state.step == 3 and len(got) == 3
    arm = "loss_mask" if case == "mask" else "loss_keypoint"
    assert got[0].keys() == {"loss_cls", "loss_box_reg", arm, "total_loss"}
    assert all(m[arm] > 0 and m["loss_box_reg"] > 0 for m in want)
    _assert_losses_close(got, want)


def _record(monkeypatch, dets):
    """Record what each package's evaluator is given."""
    for name, cls in (("p", pcoco_eval.COCODetectionEvaluator),
                      ("j", jcoco_eval.COCODetectionEvaluator)):
        process = cls.process_single

        def recording(self, image_id, boxes, scores, classes, valid,
                      masks=None, keypoints=None, _n=name, _p=process):
            dets.setdefault(_n, {})[image_id] = {
                "boxes": np.asarray(boxes), "scores": np.asarray(scores),
                "classes": np.asarray(classes), "valid": np.asarray(valid),
                "masks": masks, "keypoints": keypoints}
            return _p(self, image_id, boxes, scores, classes, valid,
                      masks=masks, keypoints=keypoints)

        monkeypatch.setattr(cls, "process_single", recording)


def test_do_test_matches_jax(setup, jtn, monkeypatch):
    case, _, jc, pc, test_name, flat = setup
    from drn_wsod_tpu.checkpoint import torch_import as jimport

    jm = jax_build_model(jc)
    variables = jimport.load_reference_weights(
        jc.MODEL.WEIGHTS, {"params": unflatten(flat)})
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    drn_wsod_torch.load_reference_weights(pc.MODEL.WEIGHTS, pm)
    probs = {}
    for name, mod in (("p", pevaluator), ("j", jevaluator)):
        make = mod.make_detect_fn

        def recording_make(*a, _n=name, _m=make, **k):
            fn = _m(*a, **k)

            def detect(*args):
                out = fn(*args)
                if "mask_probs" in out:
                    probs.setdefault(_n, []).append(
                        np.asarray(out["mask_probs"]))
                return out
            return detect
        monkeypatch.setattr(mod, "make_detect_fn", recording_make)
    monkeypatch.setattr(train_net, "make_detect_fn",
                        pevaluator.make_detect_fn)
    monkeypatch.setattr(jtn, "make_detect_fn", jevaluator.make_detect_fn)
    dets = {}
    _record(monkeypatch, dets)
    got = train_net.do_test(pc, pm, device="cpu")[test_name]
    want = jtn.do_test(jc, jm, variables)[test_name]
    task = "segm" if case == "mask" else "keypoints"
    assert list(got) == ["bbox", task] == list(want)
    assert dets["p"].keys() == dets["j"].keys() and len(dets["p"]) == 3
    for image_id, d in dets["p"].items():
        w = dets["j"][image_id]
        assert_detections_match(d, w, RTOL, ATOL, TOPK)
        np.testing.assert_array_equal(d["classes"], w["classes"])
        if case == "mask":
            np.testing.assert_array_equal(d["masks"], w["masks"])
        else:
            np.testing.assert_allclose(d["keypoints"][..., 2],
                                       w["keypoints"][..., 2], rtol=RTOL,
                                       atol=ATOL)
    if case == "mask":
        for g, w in zip(probs["p"], probs["j"]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    for t in ("bbox", task):
        for k, w in want[t].items():
            g = got[t][k]
            assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-6, (
                t, k, g, w)
    # the port's evaluator on the JAX package's own detections: bit-equal
    records = pdata.DatasetCatalog.get(test_name)
    ev = train_net.build_evaluator(pc, test_name, records)
    for image_id, d in dets["j"].items():
        ev.process_single(image_id, d["boxes"], d["scores"], d["classes"],
                          d["valid"], masks=d["masks"],
                          keypoints=d["keypoints"])
    res = ev.evaluate()
    for t in ("bbox", task):
        for k, w in want[t].items():
            g = res[t][k]
            assert (np.isnan(g) and np.isnan(w)) or g == w, (t, k)
