"""The port's VOC evaluator against the JAX package's, on the same
detections: ``voc_ap``, ``voc_eval_class`` and ``voc_eval_corloc_class`` in
both metrics (VOC07 11-point and area) at several IoU thresholds, and
``PascalVOCDetectionEvaluator.evaluate``. Both sides compute in float64, so
every result must be exactly equal. The JAX package matches in its native C
core where it is built; each comparison also runs with that core turned off
(its numpy path, the one the port copies).

The draws hold tied confidences, difficult GT boxes, images without GT of a
class (and without GT at all), classes without detections, detections on
images the GT does not list, and invalid slots."""

import numpy as np
import pytest

import drn_wsod_tpu.native
from drn_wsod_torch.evaluation import voc_eval as port
from drn_wsod_tpu.evaluation import voc_eval as ref

CLASSES = ("a", "b", "c", "d")          # "d" never has a detection


@pytest.fixture(params=["jax_default", "jax_numpy"])
def jax_path(request, monkeypatch):
    """The JAX package as it runs (native core where built), and with its
    numpy path forced."""
    if request.param == "jax_numpy":
        monkeypatch.setattr(drn_wsod_tpu.native, "available", lambda: False)
    return request.param


def _gt(seed=0, n_images=12):
    """{image_id: annotations}: 0-3 GT boxes per image over classes a-c
    (some difficult); image 'im0' has none, and class 'd' has GT on one
    image only."""
    rs = np.random.RandomState(seed)
    gt = {}
    for i in range(n_images):
        annos = []
        for _ in range(0 if i == 0 else rs.randint(0, 4)):
            x1, y1 = rs.uniform(0, 200, 2)
            w, h = rs.uniform(10, 150, 2)
            annos.append({"category_id": int(rs.randint(0, 3)),
                          "bbox": [x1, y1, x1 + w, y1 + h],
                          "difficult": int(rs.uniform() < 0.2)})
        gt[f"im{i}"] = annos
    gt["im5"].append({"category_id": 3, "bbox": [5.0, 5.0, 60.0, 70.0],
                      "difficult": 0})
    gt["im7"] = [dict(a, difficult=1) for a in gt["im7"]]   # all difficult
    return gt


def _dets(gt, class_id, seed=1, n=60):
    """(image_id, score, x1, y1, x2, y2) in VOC 1-based coordinates: jittered
    copies of the class's GT boxes and random boxes, with confidences drawn
    from few values (ties), some on an image the GT does not list."""
    rs = np.random.RandomState(seed + class_id)
    images = sorted(gt) + ["unlisted"]
    dets = []
    for _ in range(n):
        im = images[rs.randint(len(images))]
        own = [a["bbox"] for a in gt.get(im, []) if a["category_id"] == class_id]
        if own and rs.uniform() < 0.6:
            b = np.asarray(own[rs.randint(len(own))]) + rs.uniform(-15, 15, 4)
        else:
            x1, y1 = rs.uniform(0, 200, 2)
            b = np.array([x1, y1, x1 + rs.uniform(5, 150),
                          y1 + rs.uniform(5, 150)])
        score = float(rs.choice([0.9, 0.7, 0.5, 0.3]) if rs.uniform() < 0.5
                      else rs.uniform())
        dets.append((im, score, float(b[0]) + 1.0, float(b[1]) + 1.0,
                     float(b[2]), float(b[3])))
    return dets


@pytest.mark.parametrize("use_07", [True, False], ids=["voc07", "area"])
def test_voc_ap_equal(use_07):
    rs = np.random.RandomState(2)
    for n in (1, 7, 40):
        tp = np.cumsum(rs.uniform(size=n) < 0.6).astype(np.float64)
        rec = tp / max(n - 3, 1)
        prec = tp / np.arange(1, n + 1)
        assert port.voc_ap(rec, prec, use_07) == ref.voc_ap(rec, prec, use_07)


@pytest.mark.parametrize("thresh", [0.5, 0.7, 0.95])
@pytest.mark.parametrize("use_07", [True, False], ids=["voc07", "area"])
def test_class_ap_and_corloc_equal(jax_path, use_07, thresh):
    gt = _gt()
    seen = set()
    for class_id in range(len(CLASSES)):
        dets = _dets(gt, class_id) if class_id < 3 else []
        ap = port.voc_eval_class(dets, gt, class_id, thresh, use_07)
        assert ap == ref.voc_eval_class(dets, gt, class_id, thresh, use_07)
        cl = port.voc_eval_corloc_class(dets, gt, class_id, thresh)
        assert cl == ref.voc_eval_corloc_class(dets, gt, class_id, thresh)
        seen.add((ap > 0, cl > 0))
    if thresh == 0.5:
        assert (True, True) in seen        # the draws are not all misses


def test_tied_confidences_keep_their_order(jax_path):
    """Two detections of one GT box with the same score: the first listed
    takes the GT (a true positive), the second is a duplicate."""
    gt = {"x": [{"category_id": 0, "bbox": [10.0, 10.0, 50.0, 50.0],
                 "difficult": 0}],
          "y": [{"category_id": 0, "bbox": [0.0, 0.0, 20.0, 20.0],
                 "difficult": 0}]}
    dets = [("x", 0.5, 11.0, 11.0, 50.0, 50.0),
            ("y", 0.5, 100.0, 100.0, 120.0, 120.0),
            ("x", 0.5, 12.0, 12.0, 49.0, 51.0)]
    for use_07 in (True, False):
        for order in (dets, dets[::-1]):
            got = port.voc_eval_class(order, gt, 0, 0.5, use_07)
            assert got == ref.voc_eval_class(order, gt, 0, 0.5, use_07)
    assert port.voc_eval_corloc_class(dets, gt, 0, 0.5) == \
        ref.voc_eval_corloc_class(dets, gt, 0, 0.5) == 0.5


@pytest.mark.parametrize("year", [2007, 2012])
def test_evaluator_equal(jax_path, year):
    gt = _gt(seed=4)
    rs = np.random.RandomState(5)
    evs = [port.PascalVOCDetectionEvaluator(CLASSES, gt, year),
           ref.PascalVOCDetectionEvaluator(CLASSES, gt, year)]
    for image_id in sorted(gt):
        k = 12
        boxes = np.zeros((k, 4), np.float32)
        xy = rs.uniform(0, 200, (k, 2))
        boxes[:, :2] = xy
        boxes[:, 2:] = xy + rs.uniform(5, 150, (k, 2))
        own = [a for a in gt[image_id] if a["category_id"] < 3]
        classes = rs.randint(0, 3, k)
        for j, a in enumerate(own[:k]):          # some hits
            boxes[j] = np.asarray(a["bbox"]) + rs.uniform(-8, 8, 4)
            classes[j] = a["category_id"]
        scores = np.round(rs.uniform(0, 1, k), 1).astype(np.float32)  # ties
        valid = rs.uniform(size=k) < 0.8
        boxes[~valid] = 0.0                      # invalid slots, as NMS pads
        for ev in evs:
            ev.process_single(image_id, boxes, scores, classes, valid)
    got, want = (ev.evaluate() for ev in evs)
    assert got == want
    assert got["bbox"]["AP50"] > 0 and got["bbox CorLoc"]["CL50"] > 0
    assert got["bbox"]["AP50_per_class"]["d"] == 0.0
