"""The port's training entry point on COCO-format data and with trainable
BatchNorm + PreciseBN, against the JAX package's ``tools/train_net.py`` on
the CPU.

The data: a COCO instances json the test writes (80 categories under
sparse ids, crowd boxes, an image without annotations), JPEG images and a
proposals pickle keyed by the integer image ids, registered in both
packages with their own ``register_coco_instances``. The config: the COCO
YAML (``COCO-Detection/oicr_WSR_50_DC5_1x.yaml``) at the toy size of
``tests/test_torch_train_net.py`` (R18-WS, DAN [64, 64], P = 64, float32,
dropout 0, two sizes in one bucket, two images a batch), both packages
loading one Detectron2 ``.pkl`` written from numpy weights.

1. ``do_train`` for 3 steps, then ``do_test`` through the test loader into
   the COCO box evaluator, from the same weights: each step's losses within
   rtol 1e-4 and atol 1e-5 (float32; the summation orders differ), each
   image's detections as in ``tests/test_torch_eval_slice.py``, and the
   COCO metrics to 1e-6 (NaN where the JAX package gives NaN).
2. The same with ``MODEL.RESNETS.NORM BN`` and ``TEST.PRECISE_BN.ENABLED``
   (``NUM_ITER`` 2, the hook at iteration 2 of 3 and after training): the
   statistics after training bit for bit as the JAX package's, BatchNorm's
   affine unchanged, each step's images the JAX package's and those of a
   fresh loader's first three batches (a fresh iterator of the train
   loader shares no state with the training stream in either package),
   and the losses within the same tolerance up to the first step where a
   refinement branch's targets sit on the IoU threshold: where a proposal's
   IoU with a pseudo box is within 1e-6 of 0.5, the last bit of the
   float32 IoU decides its label, and the JAX package's jitted IoU differs
   in that bit from its op-by-op IoU (which the port's equals) on about 7%
   of pairs of boxes with fractional coordinates, as resized proposals
   have. At that step every loss but those branches' is compared; later
   steps start from parameters that moved apart. This data meets the case
   at step 0, branch 2 (ROADMAP.md section 3).
"""

import pickle

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch import data as pdata
from drn_wsod_torch.data.datasets import coco as pcoco
from drn_wsod_torch.engine import precise_bn as pprecise
from drn_wsod_torch.evaluation import coco_eval as pcoco_eval
from drn_wsod_torch.models.heads import oicr as poicr
from drn_wsod_torch.structures import boxes as pboxes
from drn_wsod_torch.tools import train_net
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import coco as jcoco
from drn_wsod_tpu.evaluation import coco_eval as jcoco_eval
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_bn import bn_variables
from test_torch_coco import write_coco_json
from test_torch_common import (CONFIGS, TOY, assert_detections_match,
                               cfg_pair, d2_state_dict, flatten, jax_batch,
                               param_shapes, random_params)
from test_torch_train_net import (_assert_losses_close, _jax_train,
                                  _jax_train_net, _port_train, _with)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TRAIN, TEST = "torch_coco_tn_train", "torch_coco_tn_test"
COCO_YAML = str(CONFIGS / "COCO-Detection" / "oicr_WSR_50_DC5_1x.yaml")
TOPK = 3


def write_coco_split(root, name, n_images, seed, n_props=90):
    """A COCO split under ``root``: the instances json, one JPEG an image
    (smooth random content) and a Detectron2 proposals pickle keyed by the
    integer image ids. Returns (json, image dir, proposals)."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    image_dir = root / name
    image_dir.mkdir(parents=True)
    jf = str(root / f"{name}.json")
    coco = write_coco_json(jf, n_images=n_images, seed=seed)
    props = {"ids": [], "boxes": [], "objectness_logits": [], "bbox_mode": 0}
    for img in coco["images"]:
        h, w = img["height"], img["width"]
        base = rs.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(
            np.uint8)
        Image.fromarray(base).resize((w, h), Image.BILINEAR).save(
            image_dir / img["file_name"], quality=90)
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
    return jf, str(image_dir), prop_file


def _d2_weights(root, jc, bn: bool):
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    batch = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, 80, seed=3,
                                           device="cpu")

    def init():
        return jm.init({"params": key, "dropout": key}, jax_batch(batch),
                       train=False)
    if bn:
        flat, stats = bn_variables(init, seed=5)
        sd = drn_wsod_torch.params_from_jax(flat, stats)
    else:
        sd = drn_wsod_torch.params_from_jax(random_params(param_shapes(init),
                                                          seed=5))
    path = root / f"model_init_{'bn' if bn else 'frozen'}.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": d2_state_dict(sd)}, f)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_train_net")
    train = write_coco_split(root, "train", 7, seed=31)
    test = write_coco_split(root, "test", 3, seed=32)
    for reg in (pcoco.register_coco_instances, jcoco.register_coco_instances):
        reg(TRAIN, train[0], train[1])
        reg(TEST, test[0], test[1])
    for pkg in (pdata, jdata):          # load once: the metadata is set then
        pkg.DatasetCatalog.get(TRAIN)
        pkg.DatasetCatalog.get(TEST)
    opts = (*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
            "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0,
            "INPUT.MIN_SIZE_TRAIN", (48, 64), "INPUT.MAX_SIZE_TRAIN", 90,
            "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 90,
            "INPUT.BUCKETS", [96], "SOLVER.IMS_PER_BATCH", 2,
            "SOLVER.MAX_ITER", 3, "SOLVER.CHECKPOINT_PERIOD", 2,
            "SOLVER.STEPS_PER_DISPATCH", 1, "SEED", 0,
            "TEST.AUG.ENABLED", False, "TEST.EVAL_PERIOD", 0,
            "TEST.EVAL_TRAIN", False, "TEST.DETECTIONS_PER_IMAGE", TOPK,
            "DATASETS.TRAIN", (TRAIN,), "DATASETS.TEST", (TEST,),
            "DATASETS.PROPOSAL_FILES_TRAIN", (train[2],),
            "DATASETS.PROPOSAL_FILES_TEST", (test[2],),
            "DATALOADER.NUM_WORKERS", 0, "PARALLEL.MESH_SHAPE", [1])
    jc, pc = cfg_pair(*opts, yaml=COCO_YAML)
    assert pc.MODEL.ROI_HEADS.NUM_CLASSES == 80
    jbn, pbn = cfg_pair(*opts, "MODEL.RESNETS.NORM", "BN",
                        "TEST.PRECISE_BN.ENABLED", True,
                        "TEST.PRECISE_BN.NUM_ITER", 2, yaml=COCO_YAML)
    for cfgs, bn in (((jc, pc), False), ((jbn, pbn), True)):
        weights = _d2_weights(root, cfgs[0], bn)
        for cfg in cfgs:
            cfg.MODEL.WEIGHTS = weights
    yield root, (jc, pc), (jbn, pbn), _jax_train_net()
    for pkg in (pdata, jdata):
        pkg.DatasetCatalog.remove(TRAIN)
        pkg.DatasetCatalog.remove(TEST)


def _metrics_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-6, (k, g, w)


def test_coco_do_train_and_do_test_match_jax(setup, monkeypatch):
    root, (jc, pc), _, jtn = setup
    jc3 = _with(jc, OUTPUT_DIR=str(root / "out" / "jax"))
    pc3 = _with(pc, OUTPUT_DIR=str(root / "out" / "port"))
    _, want = _jax_train(jtn, jc3, monkeypatch)
    trainer, got, _ = _port_train(pc3, monkeypatch)
    assert trainer.state.step == 3 and len(got) == 3
    assert {"loss_cls", "loss_cls_r2", "total_loss"} <= got[0].keys()
    _assert_losses_close(got, want)

    # do_test through the test loader, from the same weights
    from drn_wsod_tpu.checkpoint import torch_import as jimport
    from drn_wsod_tpu.engine.defaults import _init_variables

    jm = jax_build_model(jc)
    variables = jimport.load_reference_weights(jc.MODEL.WEIGHTS,
                                               _init_variables(jm, jc))
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    drn_wsod_torch.load_reference_weights(pc.MODEL.WEIGHTS, pm)
    dets = {}
    for name, cls in (("p", pcoco_eval.COCODetectionEvaluator),
                      ("j", jcoco_eval.COCODetectionEvaluator)):
        process = cls.process_single

        def recording(self, image_id, boxes, scores, classes, valid,
                      _n=name, _p=process):
            dets.setdefault(_n, {})[image_id] = {
                "boxes": np.asarray(boxes), "scores": np.asarray(scores),
                "classes": np.asarray(classes), "valid": np.asarray(valid)}
            return _p(self, image_id, boxes, scores, classes, valid)

        monkeypatch.setattr(cls, "process_single", recording)
    got = train_net.do_test(pc, pm, device="cpu")[TEST]
    want = jtn.do_test(jc, jm, variables)[TEST]
    assert dets["p"].keys() == dets["j"].keys() and len(dets["p"]) == 3
    for image_id, d in dets["p"].items():
        assert_detections_match(d, dets["j"][image_id], RTOL, ATOL, TOPK)
    assert list(got) == ["bbox"]
    _metrics_close(got["bbox"], want["bbox"])
    # the port's evaluator on the JAX package's own detections: bit-equal
    records = pdata.DatasetCatalog.get(TEST)
    ev = train_net.build_evaluator(pc, TEST, records)
    for image_id, d in dets["j"].items():
        ev.process_single(image_id, d["boxes"], d["scores"], d["classes"],
                          d["valid"])
    for k, w in want["bbox"].items():
        g = ev.evaluate()["bbox"][k]
        assert (np.isnan(g) and np.isnan(w)) or g == w, k


def _on_iou_threshold(proposals, mask, pgt, threshold=0.5, tol=1e-6):
    """Whether a valid proposal's IoU with a valid pseudo box is within
    ``tol`` of ``threshold`` (computed in float64)."""
    iou = pboxes.pairwise_iou(pgt.boxes.double(), proposals.double())
    near = (iou - threshold).abs() < tol
    return bool((near & pgt.valid[..., None] & mask[:, None, :]).any())


def test_bn_precise_bn_trajectory_matches_jax(setup, monkeypatch):
    root, _, (jbn, pbn), jtn = setup
    jc3 = _with(jbn, OUTPUT_DIR=str(root / "out_bn" / "jax"))
    pc3 = _with(pbn, OUTPUT_DIR=str(root / "out_bn" / "port"))

    jax_ids, port_ids, hook_batches = [], [], []
    make = jtn.make_sharded_train_step

    def jax_recording(*a, **k):
        fn = make(*a, **k)

        def step(state, batch, rng):
            jax_ids.append(np.asarray(jax.device_get(batch.image_id)))
            return fn(state, batch, rng)
        return step
    monkeypatch.setattr(jtn, "make_sharded_train_step", jax_recording)
    jstate, want = _jax_train(jtn, jc3, monkeypatch)

    forward = pprecise.train_forward
    in_step, boundary = [], []
    mine = poicr.mine_pgt

    def mining(prev, boxes, mask, labels, evidence):
        pgt = mine(prev, boxes, mask, labels, evidence)
        if in_step:
            boundary.append(_on_iou_threshold(boxes, mask, pgt))
        return pgt
    monkeypatch.setattr(poicr, "mine_pgt", mining)

    def counting(model, batch):
        hook_batches.append(batch.image_id.numpy().copy())
        return forward(model, batch)
    monkeypatch.setattr(pprecise, "train_forward", counting)
    model_step = drn_wsod_torch.engine.trainer.make_train_step

    def port_recording(*a, **k):
        fn = model_step(*a, **k)

        def step(state, batch, seed):
            port_ids.append(batch.image_id.numpy().copy())
            in_step.append(1)
            try:
                return fn(state, batch, seed)
            finally:
                in_step.clear()
        return step
    monkeypatch.setattr(drn_wsod_torch.engine.trainer, "make_train_step",
                        port_recording)
    trainer, got, restored = _port_train(pc3, monkeypatch)
    assert trainer.state.step == 3 and len(got) == 3
    assert len(boundary) == 3 * 3                   # 3 branches a step
    assert boundary[:3] == [False, False, True]     # as the docstring says
    first = next((i // 3 for i, b in enumerate(boundary) if b), 3)
    _assert_losses_close(got[:first], want[:first])
    if first < 3:
        skip = {"total_loss"} | {f"loss_cls_r{k}" for k in range(3)
                                 if boundary[first * 3 + k]}
        assert len(skip) < 4
        _assert_losses_close(
            [{k: v for k, v in got[first].items() if k not in skip}],
            [{k: v for k, v in want[first].items() if k not in skip}])

    # the hook: after step 2 (period 2) and after training, 2 batches each,
    # the first two of a fresh stream; the steps' own stream unmoved
    fresh = iter(pdata.build_detection_train_loader(
        pc3, pdata.DatasetMapper(pc3, is_train=True)))
    first = [next(fresh).image_id.numpy() for _ in range(3)]
    assert len(hook_batches) == 4
    for ids, want_ids in zip(hook_batches, first[:2] * 2):
        np.testing.assert_array_equal(ids, want_ids)
    for p_ids, j_ids, f_ids in zip(port_ids, jax_ids, first):
        np.testing.assert_array_equal(p_ids, j_ids)
        np.testing.assert_array_equal(p_ids, f_ids)

    # statistics bit for bit as JAX's; the affine never trained
    want_stats = drn_wsod_torch.params_from_jax(
        {}, flatten(jstate.params["batch_stats"]))
    sd = trainer.state.model.state_dict()
    assert want_stats and all(
        torch.equal(sd[k], v) for k, v in want_stats.items())
    moved = [k for k in want_stats if not torch.equal(sd[k], restored[
        f"model.{k}"])]
    assert moved                    # PreciseBN rounded some of them
    for k, t in sd.items():
        if k.endswith((".norm.weight", ".norm.bias")):
            assert torch.equal(t, restored[f"model.{k}"]), k
