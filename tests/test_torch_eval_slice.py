"""The port's evaluation entry point end to end against the JAX package's
composition, on the CPU: ``drn_wsod_torch.tools.train_net.do_test`` over a
VOC-layout directory of four JPEG images and a proposals pickle (the last
image without annotations), toy flagship config (R18, DAN [64, 64], P = 64,
float32), TTA over 2 scales x flip, against ``GeneralizedRCNNWithTTAAVG`` and
``PascalVOCDetectionEvaluator`` of the JAX package (what its
``tools/train_net.py:do_test`` runs) with the same weights; and
``inference_on_dataset`` (the loop without TTA) against the JAX package's.

Tolerance: each image's detections as in ``tests/test_torch_slice.py``
(rtol 1e-4, atol 1e-5 times the largest value; classes and boxes equal
wherever a score stands apart by more than that). AP and CorLoc must agree
to 1e-6 given that no two detections of a class lie within that tolerance
of each other, which the test asserts on its draws. The CLI's ``main`` on
the same directory, with the same weights written as a Detectron2
checkpoint, must give ``do_test``'s results exactly."""

import pickle

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch import data as pdata
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_torch.evaluation import voc_eval as pvoc_eval
from drn_wsod_torch.tools import train_net
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu import tta as jtta
from drn_wsod_tpu.data.datasets import voc as jvoc
from drn_wsod_tpu.evaluation.evaluator import \
    inference_on_dataset as jax_inference_on_dataset
from drn_wsod_tpu.evaluation.evaluator import make_detect_fn as jax_detect_fn
from drn_wsod_tpu.evaluation.voc_eval import PascalVOCDetectionEvaluator
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (FLAGSHIP, TOY, VOC_OBJECT,
                               assert_detections_match,
                               cfg_pair, d2_state_dict, jax_batch,
                               param_shapes, random_params, unflatten,
                               write_voc)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
NAME = "torch_eval_slice_test"
SIZES = [(40, 56), (64, 48), (33, 70), (50, 50)]
# few detections per image: random weights give every proposal about the
# same class scores, and a ranking of many would hold ties within the
# tolerance, where the order, and so AP, is not decided
TOPK = 3
OPTS = ("MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
        "TEST.AUG.ENABLED", True, "TEST.AUG.MIN_SIZES", (40, 72),
        "TEST.AUG.MAX_SIZE", 200, "INPUT.BUCKETS", [64, 96],
        "TEST.DETECTIONS_PER_IMAGE", TOPK, "TEST.EVAL_TRAIN", False)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    d, prop_file, _ = write_voc(root, SIZES, pvoc.VOC_CLASS_NAMES, seed=11,
                                n_props=80)
    jc, pc = cfg_pair(*TOY, *OPTS, "DATASETS.TEST", (NAME,),
                      "DATASETS.PROPOSAL_FILES_TEST", (prop_file,))
    pvoc.register_pascal_voc(NAME, d, "test", 2007)
    jvoc.register_pascal_voc(NAME, d, "test", 2007)
    init = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, 20, seed=3,
                                          device="cpu")
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(init), train=False)),
        seed=2)
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    yield root, prop_file, jc, pc, jm, {"params": unflatten(flat)}, pm
    pdata.DatasetCatalog.remove(NAME)
    jdata.DatasetCatalog.remove(NAME)


def _jax_do_test(jc, jm, variables):
    """The TTA arm of the JAX package's ``tools/train_net.py:do_test`` for
    one dataset: per-image detections and the evaluator's results."""
    records = jdata.get_detection_dataset_dicts(
        [NAME], [jc.DATASETS.PROPOSAL_FILES_TEST[0]], filter_empty=False)
    meta = jdata.MetadataCatalog.get(NAME)
    evaluator = PascalVOCDetectionEvaluator(
        meta.thing_classes,
        {str(r["image_id"]): r.get("annotations", []) for r in records},
        year=meta.get("year", 2007))
    tta = jtta.GeneralizedRCNNWithTTAAVG(jc, jm, variables)
    dets = {}
    for r in records:
        d = tta(r)
        dets[str(r["image_id"])] = d
        evaluator.process_single(str(r["image_id"]), d["boxes"], d["scores"],
                                 d["classes"], d["valid"])
    return dets, evaluator.evaluate()


def _class_scores_apart(dets):
    """Whether, per class, every two valid detections' scores are further
    apart than the tolerance."""
    by_class = {}
    top = max(float(np.abs(d["scores"]).max()) for d in dets.values())
    for d in dets.values():
        for s, c, v in zip(d["scores"], d["classes"], d["valid"]):
            if v:
                by_class.setdefault(int(c), []).append(float(s))
    for scores in by_class.values():
        s = np.sort(scores)
        if (np.diff(s) <= ATOL * top + RTOL * s[1:]).any():
            return False
    return True


def _annotate_from(dets, voc_dir, sizes):
    """Rewrite the annotations of all images but the last: each image's
    GT is its top detection (one of them difficult) and a box of the next
    class beside it, so AP and CorLoc are not all 0 with random weights."""
    for i, (image_id, d) in enumerate(sorted(dets.items())[:-1]):
        h, w = sizes[i]
        x1, y1, x2, y2 = np.round(d["boxes"][0]).astype(int)
        objs = [(int(d["classes"][0]), (x1 + 1, y1 + 1, x2, y2), i == 1),
                ((int(d["classes"][0]) + 1) % 20, (1, 1, w // 2, h // 2),
                 False)]
        xml = "".join(VOC_OBJECT.format(
            name=pvoc.VOC_CLASS_NAMES[c], difficult=f"<difficult>{int(df)}"
            "</difficult>", x1=b[0], y1=b[1], x2=b[2], y2=b[3])
            for c, b, df in objs)
        (voc_dir / "Annotations" / f"{image_id}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height>"
            f"</size>\n{xml}</annotation>\n")


def test_do_test_matches_jax(setup, monkeypatch):
    root, _, jc, pc, jm, variables, pm = setup
    _annotate_from(_jax_do_test(jc, jm, variables)[0], root / "VOC2007",
                   SIZES)
    want_dets, want = _jax_do_test(jc, jm, variables)
    got_dets = {}
    process = pvoc_eval.PascalVOCDetectionEvaluator.process_single

    def recording(self, image_id, boxes, scores, classes, valid):
        got_dets[image_id] = {"boxes": boxes, "scores": scores,
                              "classes": classes, "valid": valid}
        return process(self, image_id, boxes, scores, classes, valid)

    monkeypatch.setattr(pvoc_eval.PascalVOCDetectionEvaluator,
                        "process_single", recording)
    results = train_net.do_test(pc, pm, eval_train=True, device="cpu")
    assert list(results) == [NAME]
    got = results[NAME]

    assert got_dets.keys() == want_dets.keys() and len(got_dets) == 4
    for image_id, d in got_dets.items():
        assert_detections_match(d, want_dets[image_id], RTOL, ATOL, TOPK)
    assert _class_scores_apart(want_dets)
    for task in ("bbox", "bbox CorLoc"):
        keys = [k for k, v in want[task].items() if isinstance(v, float)]
        assert keys and set(keys) <= set(got[task])
        for k in keys:
            assert abs(got[task][k] - want[task][k]) <= 1e-6, (task, k)
    assert got["bbox"]["AP50_per_class"] == pytest.approx(
        want["bbox"]["AP50_per_class"], abs=1e-6)
    assert got["bbox"]["AP50"] > 0 and got["bbox CorLoc"]["CL50"] > 0


def test_inference_on_dataset_matches_jax(setup, monkeypatch):
    """The dataset loop without TTA (``make_detect_fn`` per batch, the
    last batch padded) into the VOC evaluator, against the JAX package's
    loop; GT drawn from the JAX detections so AP and CorLoc are not 0."""
    from drn_wsod_torch.evaluation import evaluator as port_evaluator

    _, _, _, pc, jm, variables, pm = setup
    batches = []
    for s in range(3):
        b = drn_wsod_torch.synthetic_batch(2, 64, 64, 64, 20, seed=20 + s,
                                           device="cpu")
        b.image_id[:] = torch.tensor([2 * s, 2 * s + 1], dtype=torch.int32)
        batches.append((b, 2 if s < 2 else 1))
    records = [{"image_id": f"im{i}"} for i in range(6)]
    jax_detect = jax_detect_fn(jm, 1e-5, 0.3, TOPK)
    gt = {}
    for b, n in batches:
        d = jax_detect(variables, jax_batch(b))
        for i in range(n):
            image_id = f"im{int(b.image_id[i])}"
            box = [float(v) for v in np.asarray(d["boxes"][i, 0])]
            gt[image_id] = [{"category_id": int(d["classes"][i, 0]),
                             "bbox": box, "difficult": 0},
                            {"category_id": 5, "bbox": [1.0, 2.0, 30.0, 20.0],
                             "difficult": 0}]
    names = pvoc.VOC_CLASS_NAMES
    want_ev = PascalVOCDetectionEvaluator(names, gt)
    want = jax_inference_on_dataset(
        jax_detect, variables, [(jax_batch(b), n) for b, n in batches],
        want_ev, records)
    seen = {}
    process = pvoc_eval.PascalVOCDetectionEvaluator.process_single

    def recording(self, image_id, boxes, scores, classes, valid):
        seen[image_id] = {"scores": scores, "classes": classes,
                          "valid": valid}
        return process(self, image_id, boxes, scores, classes, valid)

    monkeypatch.setattr(pvoc_eval.PascalVOCDetectionEvaluator,
                        "process_single", recording)
    got = port_evaluator.inference_on_dataset(
        drn_wsod_torch.make_detect_fn(pm, 1e-5, 0.3, TOPK, device="cpu"),
        batches, pvoc_eval.PascalVOCDetectionEvaluator(names, gt), records)
    assert sorted(seen) == sorted(gt) and len(seen) == 5
    assert _class_scores_apart(seen)
    for task in ("bbox", "bbox CorLoc"):
        for k, v in want[task].items():
            if isinstance(v, float):
                assert abs(got[task][k] - v) <= 1e-6, (task, k)
    assert got["bbox"]["AP50"] > 0 and got["bbox CorLoc"]["CL50"] > 0


def test_gather_refuses_several_processes(monkeypatch):
    from drn_wsod_torch.evaluation import gather_and_evaluate

    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 16"):
        gather_and_evaluate(None)


def test_cli_main_matches_do_test(setup, monkeypatch):
    """``main`` on $DETECTRON2_DATASETS/VOC2007 with the weights written
    as a Detectron2 checkpoint, and ``voc_2007_test`` as the test set."""
    root, prop_file, _, pc, _, _, pm = setup
    weights = root / "model_final.pkl"
    with open(weights, "wb") as f:
        pickle.dump({"model": d2_state_dict(pm.state_dict())}, f)
    monkeypatch.setenv("DETECTRON2_DATASETS", str(root))
    voc_names = [n for n in pdata.DatasetCatalog.list()
                 if n.startswith("voc_20")]
    for name in voc_names:
        # main keeps a registration it finds, which may be under another root
        monkeypatch.delitem(pdata.DatasetCatalog._registry, name)
    opts = []
    for k, v in zip(TOY[0::2] + OPTS[0::2], TOY[1::2] + OPTS[1::2]):
        opts += [k, v if isinstance(v, str) else repr(v)]
    opts += ["DATASETS.PROPOSAL_FILES_TEST", repr((prop_file,)),
             "MODEL.WEIGHTS", str(weights)]
    args = train_net.argument_parser().parse_args(
        ["--config-file", FLAGSHIP, "--eval-only", *opts])
    try:
        results = train_net.main(args, device="cpu")
    finally:
        for name in pdata.DatasetCatalog.list():
            if name.startswith("voc_20"):
                pdata.DatasetCatalog.remove(name)
    pc_test = pc.clone()
    pc_test.DATASETS.TEST = ("voc_2007_test",)
    pvoc.register_pascal_voc("voc_2007_test", str(root / "VOC2007"), "test",
                             2007)
    try:
        want = train_net.do_test(pc_test, pm, device="cpu")
    finally:
        pdata.DatasetCatalog.remove("voc_2007_test")
    assert list(results) == ["voc_2007_test"]
    assert results == want


def test_cli_refuses_what_is_not_ported():
    parse = train_net.argument_parser().parse_args
    with pytest.raises(SystemExit, match="item 11"):
        train_net.main(parse(["--config-file", FLAGSHIP]), device="cpu")
    with pytest.raises(SystemExit, match="item 11"):
        train_net.main(parse(["--eval-only", "--resume"]), device="cpu")
    _, pc = cfg_pair(*TOY, "TEST.AUG.ENABLED", False)
    with pytest.raises(NotImplementedError, match="item 10"):
        train_net.do_test(pc, None, device="cpu")
    meta = pdata.MetadataCatalog.get("torch_eval_slice_coco")
    meta.set(evaluator_type="coco")
    with pytest.raises(NotImplementedError, match="item 15"):
        train_net.build_evaluator(pc, "torch_eval_slice_coco", [])
