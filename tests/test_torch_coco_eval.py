"""The port's COCO box evaluator (``evaluation/coco_eval.py``) against the
JAX package's, bit for bit: both are float64 numpy, so every metric must be
equal (NaN where the JAX package gives NaN).

The detections are drawn from a seed: more than 100 an image for some
classes (the cap), boxes of every area range, near-duplicates of GT boxes
at several IoUs, crowd (difficult) GT, classes with detections but no GT
and classes with GT but no detection, an image without GT, invalid slots;
and split in two halves merged through ``state_dict`` / ``merge_states``.
"""

import pickle

import numpy as np
import pytest

from drn_wsod_torch.evaluation import coco_eval as pe
from drn_wsod_tpu.evaluation import coco_eval as je

C = 12


def _scenario(seed: int):
    """({image_id: annotations}, [(image_id, boxes, scores, classes,
    valid)])."""
    rs = np.random.RandomState(seed)
    gt, dets = {}, []
    for i in range(7):
        img = f"img{i}"
        annos = []
        n_gt = 0 if i == 6 else rs.randint(1, 9)
        for _ in range(n_gt):
            # every area range: sides from 4 to 300 px
            side = float(np.exp(rs.uniform(np.log(4), np.log(300))))
            x, y = rs.uniform(0, 400, 2)
            w, h = side * rs.uniform(0.6, 1.4), side * rs.uniform(0.6, 1.4)
            annos.append({"category_id": int(rs.randint(0, C - 3)),
                          "bbox": [x, y, x + w, y + h],
                          "difficult": int(rs.uniform() < 0.15)})
        gt[img] = annos
        boxes, scores, classes = [], [], []
        for a in annos:                     # jittered copies of each GT
            for _ in range(rs.randint(0, 4)):
                b = np.asarray(a["bbox"]) + rs.randn(4) * rs.choice(
                    [0.5, 3.0, 12.0])
                boxes.append(b)
                scores.append(rs.uniform())
                classes.append(a["category_id"] if rs.uniform() < 0.8
                               else rs.randint(0, C))
        n_bg = 130 if i in (1, 4) else rs.randint(5, 40)
        for _ in range(n_bg):               # background, some classes > 100
            x, y = rs.uniform(0, 450, 2)
            w, h = np.exp(rs.uniform(np.log(3), np.log(250), 2))
            boxes.append([x, y, x + w, y + h])
            scores.append(np.round(rs.uniform(), 2))    # ties
            classes.append(1 if i in (1, 4) and rs.uniform() < 0.9
                           else rs.randint(0, C))
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32)
        classes = np.asarray(classes, np.int32)
        valid = rs.uniform(size=len(scores)) < 0.95
        dets.append((img, boxes, scores, classes, valid))
    return gt, dets


def _metrics_equal(got, want):
    assert got.keys() == want.keys()
    for task in want:
        assert got[task].keys() == want[task].keys()
        for k, w in want[task].items():
            g = got[task][k]
            assert (np.isnan(g) and np.isnan(w)) or g == w, (task, k, g, w)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_bit_equal_to_jax(seed):
    gt, dets = _scenario(seed)
    names = [f"c{i}" for i in range(C)]
    p, j = pe.COCODetectionEvaluator(names, gt), je.COCODetectionEvaluator(
        names, gt)
    for d in dets:
        p.process_single(*d)
        j.process_single(*d)
    counts = [sum(1 for c in d[3][d[4]] if c == 1) for d in dets]
    assert max(counts) > 100                     # the cap binds
    got, want = p.evaluate(), j.evaluate()
    _metrics_equal(got, want)
    assert np.isfinite(got["bbox"]["AP"])
    # classes C-3.. have no GT: NaN for them, excluded from the means
    no_gt = pe.COCODetectionEvaluator(names[-3:], {
        k: [] for k in gt})
    for d in dets:
        no_gt.process_single(*d)
    assert all(np.isnan(v) for v in no_gt.evaluate()["bbox"].values())


def test_merge_states_of_two_halves():
    gt, dets = _scenario(3)
    names = [f"c{i}" for i in range(C)]
    whole = pe.COCODetectionEvaluator(names, gt)
    halves = [pe.COCODetectionEvaluator(names, gt) for _ in range(2)]
    for i, d in enumerate(dets):
        whole.process_single(*d)
        halves[i % 2].process_single(*d)
    states = [pickle.loads(pickle.dumps(h.state_dict())) for h in halves]
    merged = pe.COCODetectionEvaluator(names, gt)
    merged.merge_states(states)
    j = je.COCODetectionEvaluator(names, gt)
    j.merge_states(states)
    want = whole.evaluate()
    _metrics_equal(merged.evaluate(), want)
    _metrics_equal(j.evaluate(), want)
    # the JAX package's states merge into the port's, the legacy box-only
    # layout too
    jh = je.COCODetectionEvaluator(names, gt)
    for d in dets:
        jh.process_single(*d)
    from_jax = pe.COCODetectionEvaluator(names, gt)
    from_jax.merge_states([jh.state_dict()])
    _metrics_equal(from_jax.evaluate(), want)
    legacy = pe.COCODetectionEvaluator(names, gt)
    legacy.merge_states([jh.state_dict()["box"]])
    _metrics_equal(legacy.evaluate(), want)


def test_primitives_bit_equal_to_jax():
    rs = np.random.RandomState(4)
    det = rs.uniform(0, 50, (40, 4))
    det[:, 2:] += det[:, :2]
    gt = rs.uniform(0, 50, (9, 4))
    gt[:, 2:] += gt[:, :2]
    gt[3] = gt[2]                               # a degenerate pair
    np.testing.assert_array_equal(pe._iou_matrix(det, gt),
                                  je._iou_matrix(det, gt))
    ign = rs.uniform(size=9) < 0.3
    scores = np.round(rs.uniform(size=40), 1)
    for got, want in zip(pe._match_image(det, scores, gt, ign, pe.IOU_THRS,
                                         25),
                         je._match_image(det, scores, gt, ign, je.IOU_THRS,
                                         25)):
        np.testing.assert_array_equal(got, want)
    tp = rs.uniform(size=(10, 60)) < 0.4
    ig = rs.uniform(size=(10, 60)) < 0.1
    s = rs.uniform(size=60)
    for npos in (0, 7, 30):
        np.testing.assert_array_equal(pe._average_precision(tp, ig, s, npos),
                                      je._average_precision(tp, ig, s, npos))
    np.testing.assert_array_equal(pe.IOU_THRS, je.IOU_THRS)
    assert pe.AREA_RANGES == je.AREA_RANGES


@pytest.mark.parametrize("task", ["segm", "keypoints"])
def test_dense_tasks_raise(task):
    """The dense tasks raised item 14 here until they were ported; each now
    evaluates beside "bbox", equal to the JAX evaluator on one image
    (``tests/test_torch_coco_dense_eval.py`` holds them in full)."""
    m = np.zeros((20, 30), bool)
    m[4:12, 5:20] = True
    kp = np.zeros((17, 3))
    kp[:, :2], kp[:, 2] = (8.0, 9.0), 2
    gt = {"0": [{"category_id": 0, "bbox": [5, 4, 20, 12], "difficult": 0,
                 "iscrowd": 0, "segmentation": pe.rle_encode(m),
                 "keypoints": kp.ravel().tolist(), "area": 120.0}]}
    out = []
    for mod in (pe, je):
        ev = mod.COCODetectionEvaluator(["a"], gt, tasks=("bbox", task))
        ev.process_single("0", np.array([[5, 4, 20, 12]], np.float32),
                          np.array([0.9]), np.array([0]), masks=m[None],
                          keypoints=kp[None])
        out.append(ev.evaluate())
    assert str(out[0]) == str(out[1]) and set(out[0]) == {"bbox", task}
    assert out[0][task]["AP"] == 100.0
