"""The port's evaluation core (``drn_wsod_torch/ops/csrc/eval_core.cpp``,
bound in ``drn_wsod_torch/native.py``) against the JAX package's native
core (``native/eval_core.cpp``) and against the port's numpy twin, array
for array; and ``voc_eval_class`` / ``voc_eval_corloc_class`` against the
JAX package's at 0 tolerance. Everything is float64 on both sides, so the
IoUs, TP / FP arrays, verdicts, AP and CorLoc must be equal to the bit.

The draws hold tied confidences, difficult GT boxes, IoUs built to sit
exactly on the threshold, a class without GT, detections on an image the
GT does not list, and classes without detections."""

import numpy as np
import pytest

import drn_wsod_tpu.native as jnative
from drn_wsod_torch import native as pnative
from drn_wsod_torch.evaluation import coco_eval as pcoco
from drn_wsod_torch.evaluation import voc_eval as port
from drn_wsod_torch.ops import _build
from drn_wsod_tpu.evaluation import voc_eval as ref

THRESHOLDS = (0.5, 0.7, 0.75)
N_CLASSES = 4                     # class 3 has no GT box


def dataset(seed, n_images=14):
    """(gt_by_image, {class: dets}): 0-4 GT boxes an image over classes
    0-2, some difficult (image 'im1' all difficult, 'im0' none); per class
    jittered copies of its GT boxes, random boxes, boxes whose IoU with a
    GT box is exactly 0.5 or 0.75, confidences drawn from a few values
    (ties), some on the unlisted image 'ghost'."""
    rs = np.random.RandomState(seed)
    gt = {}
    for i in range(n_images):
        annos = []
        for _ in range(0 if i == 0 else rs.randint(1, 5)):
            x1, y1 = np.floor(rs.uniform(0, 200, 2))
            w, h = np.floor(rs.uniform(10, 120, 2))
            annos.append({"category_id": int(rs.randint(0, 3)),
                          "bbox": [x1, y1, x1 + w - 1, y1 + h - 1],
                          "difficult": int(i == 1 or rs.uniform() < 0.2)})
        gt[f"im{i}"] = annos
    dets = {c: [] for c in range(N_CLASSES)}
    for im, annos in gt.items():
        for a in annos:
            x1, y1, x2, y2 = a["bbox"]
            w = x2 - x1 + 1
            c = a["category_id"]
            for _ in range(rs.randint(0, 3)):
                j = rs.uniform(-8, 8, 4)
                dets[c].append((im, float(rs.choice([0.3, 0.5, 0.9])),
                                x1 + j[0], y1 + j[1], x2 + j[2], y2 + j[3]))
            # the same height, a width of w/2 or 3w/4 from the left edge:
            # IoU exactly 0.5 or 0.75 where w is even or divisible by 4
            for frac in (0.5, 0.75):
                dets[c].append((im, float(rs.choice([0.5, 0.9])), x1, y1,
                                x1 + w * frac - 1, y2))
    for c in range(N_CLASSES):
        for _ in range(10):
            x1, y1 = rs.uniform(0, 200, 2)
            w, h = rs.uniform(10, 120, 2)
            im = rs.choice(sorted(gt) + ["ghost"])
            dets[c].append((str(im), float(rs.choice([0.1, 0.5, 0.9])),
                            x1, y1, x1 + w, y1 + h))
    dets[2] = []                   # a class with GT and no detection
    return gt, dets


def _iou_voc(gt, det):
    iw = max(min(gt[2], det[2]) - max(gt[0], det[0]) + 1.0, 0.0)
    ih = max(min(gt[3], det[3]) - max(gt[1], det[1]) + 1.0, 0.0)
    inter = iw * ih
    return inter / ((det[2] - det[0] + 1.0) * (det[3] - det[1] + 1.0)
                    + (gt[2] - gt[0] + 1.0) * (gt[3] - gt[1] + 1.0) - inter)


def test_dataset_hits_the_thresholds_exactly():
    # the draws must reach the `>` test with an IoU equal to the threshold
    gt, dets = dataset(0)
    on = {t: 0 for t in (0.5, 0.75)}
    for c, ds in dets.items():
        for im, _, *box in ds:
            for a in gt.get(im, []):
                if a["category_id"] == c:
                    iou = _iou_voc(a["bbox"], box)
                    if iou in on:
                        on[iou] += 1
    assert on[0.5] > 0 and on[0.75] > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_voc_match_three_ways(seed, thresh):
    """The port's C++ ``voc_match`` / ``voc_corloc`` on the arrays the
    evaluator builds == the JAX core on the JAX evaluator's arrays == the
    port's numpy twin."""
    gt, dets = dataset(seed)
    for c in range(N_CLASSES):
        if not dets[c]:
            continue
        arrays = port._class_arrays(dets[c], gt, c)
        for got, want in zip(arrays,
                             ref._native_class_arrays(dets[c], gt, c)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        tp, fp = pnative.voc_match(*arrays, thresh)
        jtp, jfp = jnative.voc_match(*arrays, thresh)
        ptp, pfp, npos = port.match_class(dets[c], gt, c, thresh,
                                          native=False)
        for a, b in ((tp, jtp), (fp, jfp), (tp, ptp), (fp, pfp)):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
        assert port.match_class(dets[c], gt, c, thresh)[2] == npos
        verdict = pnative.voc_corloc(*arrays, thresh)
        np.testing.assert_array_equal(verdict,
                                      jnative.voc_corloc(*arrays, thresh))
        np.testing.assert_array_equal(
            verdict, port.corloc_verdicts(dets[c], gt, c, thresh,
                                          native=False))
        assert verdict.dtype == np.int8


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("use_07", [True, False])
def test_class_ap_and_corloc_equal_jax(seed, use_07):
    gt, dets = dataset(seed)
    for c in range(N_CLASSES):
        for thresh in THRESHOLDS:
            ap = port.voc_eval_class(dets[c], gt, c, thresh, use_07)
            assert ap == ref.voc_eval_class(dets[c], gt, c, thresh, use_07)
            assert ap == port.voc_eval_class(dets[c], gt, c, thresh, use_07,
                                             native=False)
            cl = port.voc_eval_corloc_class(dets[c], gt, c, thresh)
            assert cl == ref.voc_eval_corloc_class(dets[c], gt, c, thresh)
            assert cl == port.voc_eval_corloc_class(dets[c], gt, c, thresh,
                                                    native=False)


def test_exact_threshold_is_not_above_it():
    """IoU 0.5 exactly: an FP at 0.5 (the test is `>`), a TP at 0.49; the
    second detection of a taken GT box an FP; a difficult match neither;
    an unlisted image an FP; CorLoc judges only each image's first."""
    gt = {"a": [{"category_id": 0, "bbox": [0.0, 0.0, 9.0, 9.0]},
                {"category_id": 0, "bbox": [50.0, 50.0, 59.0, 59.0],
                 "difficult": 1}],
          "b": [{"category_id": 0, "bbox": [0.0, 0.0, 9.0, 9.0]}]}
    dets = [("a", 0.9, 0.0, 0.0, 9.0, 4.0),     # IoU 0.5 with a's first
            ("a", 0.9, 0.0, 0.0, 9.0, 9.0),     # tied, IoU 1
            ("a", 0.8, 0.0, 0.0, 9.0, 9.0),     # the same GT again
            ("a", 0.7, 50.0, 50.0, 59.0, 59.0),  # difficult
            ("ghost", 0.6, 0.0, 0.0, 9.0, 9.0),
            ("b", 0.5, 0.0, 0.0, 9.0, 4.0)]
    arrays = port._class_arrays(dets, gt, 0)
    np.testing.assert_array_equal(arrays[1], [0, 0, 0, 0, -1, 1])
    for thresh, want_tp, want_fp, want_cl in (
            (0.5, [0, 1, 0, 0, 0, 0], [1, 0, 1, 0, 1, 1], [0, 0]),
            (0.49, [1, 0, 0, 0, 0, 1], [0, 1, 1, 0, 1, 0], [1, 1])):
        for native in (True, False):
            tp, fp, npos = port.match_class(dets, gt, 0, thresh, native)
            np.testing.assert_array_equal(tp, want_tp)
            np.testing.assert_array_equal(fp, want_fp)
            assert npos == 2
            np.testing.assert_array_equal(
                port.corloc_verdicts(dets, gt, 0, thresh, native), want_cl)
        np.testing.assert_array_equal(jnative.voc_match(*arrays, thresh)[0],
                                      want_tp)


def test_no_detections_and_no_gt():
    gt, _ = dataset(1)
    for native in (True, False):
        assert port.voc_eval_class([], gt, 0, 0.5, True, native) == 0.0
        assert port.voc_eval_corloc_class([], gt, 0, 0.5, native) == 0.0
    empty = (np.zeros((0, 4)), np.zeros(0, np.int32), np.zeros((0, 4)),
             np.zeros(0, np.uint8), np.zeros(3, np.int64))
    tp, fp = pnative.voc_match(*empty, 0.5)
    assert tp.shape == fp.shape == (0,)
    np.testing.assert_array_equal(pnative.voc_corloc(*empty, 0.5),
                                  [-1, -1])
    # class 3 has no GT: every detection an FP, AP 0, CorLoc 0
    gt, dets = dataset(2)
    tp, fp, npos = port.match_class(dets[3], gt, 3, 0.5)
    assert npos == 0 and tp.sum() == 0 and fp.all()
    assert port.voc_eval_class(dets[3], gt, 3, 0.5, False) == 0.0
    assert port.voc_eval_corloc_class(dets[3], gt, 3, 0.5) == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_coco_match_equal_jax_and_numpy(seed):
    """``coco_match`` (no caller in the evaluators, as in the JAX package)
    == the JAX core == the port's COCO evaluator's numpy matching, at the
    ten COCO thresholds; GT crowd / ignored flags and ties among them."""
    rs = np.random.RandomState(seed)
    det = np.floor(rs.uniform(0, 80, (12, 4)))
    det[:, 2:] += np.floor(rs.uniform(4, 60, (12, 2)))
    gt = np.concatenate([det[:3] + rs.randint(-3, 4, (3, 4)),
                         np.floor(rs.uniform(0, 80, (4, 4)))])
    gt[3:, 2:] += 30
    ignore = np.array([0, 1, 0, 0, 1, 0, 0], np.uint8)
    det[11] = gt[4]                # on an ignored box alone
    scores = rs.choice([0.2, 0.5, 0.9], 12)
    order = np.argsort(-scores, kind="stable")
    thrs = pcoco.IOU_THRS
    tp, ign = pnative.coco_match(det[order], gt, ignore, thrs)
    jtp, jign = jnative.coco_match(det[order], gt, ignore, thrs)
    np.testing.assert_array_equal(tp, jtp)
    np.testing.assert_array_equal(ign, jign)
    ptp, pign, _ = pcoco._match_image(det, scores, gt, ignore.astype(bool),
                                      thrs, 100)
    np.testing.assert_array_equal(tp.astype(bool), ptp)
    np.testing.assert_array_equal(ign.astype(bool), pign)
    assert tp.shape == (len(thrs), 12) and tp.any() and ign.any()


@pytest.fixture
def fresh_core(tmp_path, monkeypatch):
    """The core built into an empty build directory, with the library
    caches cleared before and after (the real build is untouched)."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_host.cache_clear()
    _build.bind_host.cache_clear()
    yield tmp_path
    monkeypatch.undo()
    _build.load_host.cache_clear()
    _build.bind_host.cache_clear()


def test_missing_compiler_raises(fresh_core, monkeypatch):
    """No numpy fallback: the evaluator raises where the core cannot be
    built."""
    gt, dets = dataset(0)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        port.voc_eval_class(dets[0], gt, 0, 0.5, True)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        port.voc_eval_corloc_class(dets[0], gt, 0, 0.5)
    # the twin, asked for, needs no compiler
    assert port.voc_eval_class(dets[0], gt, 0, 0.5, True, native=False) == \
        ref.voc_eval_class(dets[0], gt, 0, 0.5, True)


def test_failed_build_raises(fresh_core, monkeypatch):
    csrc = fresh_core / "csrc"
    csrc.mkdir()
    (csrc / "eval_core.cpp").write_text('extern "C" void voc_match( {\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    with pytest.raises(RuntimeError, match="host build of eval_core.cpp"):
        pnative.voc_match(np.zeros((0, 4)), np.zeros(0, np.int32),
                          np.zeros((0, 4)), np.zeros(0, np.uint8),
                          np.zeros(1, np.int64), 0.5)


def test_built_without_contraction(fresh_core):
    """The core builds with -ffp-contract=off on top of the host flags,
    into the build directory, at first use."""
    assert _build.HOST_EXTRA_FLAGS["eval_core"] == ("-ffp-contract=off",)
    assert "-march=native" not in _build.HOST_FLAGS
    assert not _build.library_path("eval_core").exists()
    gt, dets = dataset(3)
    arrays = port._class_arrays(dets[0], gt, 0)
    np.testing.assert_array_equal(pnative.voc_match(*arrays, 0.5)[0],
                                  jnative.voc_match(*arrays, 0.5)[0])
    assert _build.library_path("eval_core").exists()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("year", [2007, 2012])
def test_evaluate_equal_jax(seed, year):
    """``evaluate`` builds each class's arrays once for its ten
    thresholds; every AP and CorLoc equals the JAX evaluator's."""
    gt, dets = dataset(seed)
    names = ("a", "b", "c", "d")
    got = port.PascalVOCDetectionEvaluator(names, gt, year)
    want = ref.PascalVOCDetectionEvaluator(names, gt, year)
    got.merge_states([dets])
    want.merge_states([dets])
    assert got.evaluate() == want.evaluate()
