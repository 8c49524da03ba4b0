"""COCO's instance-mask ("segm") and keypoint AP against the JAX
package's ``COCODetectionEvaluator``, on the CPU: every number of
``evaluate()`` equal (NaN where both are NaN), on

  * a perfect match and a shifted one (masks moved by 1-4 pixels,
    keypoints by a few), random detections among them;
  * crowd GT as uncompressed RLE (ignored, matched without penalty);
  * a class without GT, whose detections are all false;
  * an image of more than 100 detections (the cap);
  * keypoint GT with none visible (ignored);
  * a class with GT but no detection (box AP 0, dense AP NaN, as in the
    JAX package);
  * two halves processed apart and merged through ``state_dict`` /
    ``merge_states``, in either package's layout;

and the helpers (``rle_encode`` / ``rle_decode`` / ``rle_area``,
``gt_segmentation_mask``, the mask IoU and OKS matrices) bit-equal. As in
the JAX package, ``rle_decode`` takes only list counts: COCO's compressed
string counts raise ``TypeError`` in both.
"""

import math

import numpy as np
import pytest

from drn_wsod_torch.evaluation import coco_eval as pe
from drn_wsod_torch.structures.masks import rasterize_polygons
from drn_wsod_tpu.evaluation import coco_eval as je

H, W, K = 60, 80, 17
CLASSES = ["a", "b", "c"]            # "c" has no GT


def _polygon(rng, x0, y0, w, h, n=7):
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = rng.uniform(0.5, 1.0, n)
    return np.stack([x0 + w / 2 * (1 + rad * np.cos(ang)),
                     y0 + h / 2 * (1 + rad * np.sin(ang))], -1)


def _scene(seed, n_images=6):
    """GT records' annotations and per-image detections (boxes, scores,
    classes, valid, masks at (H, W), keypoints)."""
    rng = np.random.RandomState(seed)
    gt, dets = {}, {}
    for k in range(n_images):
        annos, boxes, scores, classes, masks, kps = [], [], [], [], [], []
        for g in range(rng.randint(1, 4)):
            w, h = rng.uniform(12, 40), rng.uniform(12, 30)
            x0, y0 = rng.uniform(0, W - w), rng.uniform(0, H - h)
            poly = _polygon(rng, x0, y0, w, h)
            m = rasterize_polygons([poly.ravel()], H, W)
            kp = np.zeros((K, 3))
            if g != 1:                       # the second has none visible
                kp[:, 0] = rng.uniform(x0, x0 + w, K)
                kp[:, 1] = rng.uniform(y0, y0 + h, K)
                kp[:, 2] = rng.randint(0, 3, K)
            c = int(rng.randint(0, 2))
            annos.append({"category_id": c, "bbox": [x0, y0, x0 + w, y0 + h],
                          "difficult": 0, "iscrowd": 0,
                          "area": float(m.sum()) if g else None,
                          "segmentation": [poly.ravel().tolist()],
                          "keypoints": kp.ravel().tolist()})
            for shift in ((0, 0), tuple(rng.randint(1, 5, 2))):
                boxes.append([x0 + shift[0], y0 + shift[1],
                              x0 + w + shift[0], y0 + h + shift[1]])
                scores.append(rng.uniform(0.3, 1.0))
                classes.append(c)
                masks.append(np.roll(m, shift[::-1], (0, 1)))
                q = kp.copy()
                q[:, :2] += shift + rng.normal(0, 0.5, (K, 2))
                q[:, 2] = rng.uniform(0, 1, K)
                kps.append(q)
        if k == 1:                           # a crowd region, as RLE
            cm = np.zeros((H, W), bool)
            cm[5:25, 40:75] = True
            annos.append({"category_id": 0, "bbox": [40, 5, 75, 25],
                          "difficult": 1, "iscrowd": 1,
                          "area": float(cm.sum()),
                          "segmentation": je.rle_encode(cm)})
            boxes.append([41, 6, 74, 24])
            scores.append(0.9)
            classes.append(0)
            masks.append(cm)
            kps.append(np.zeros((K, 3)))
        n_rand = 120 if k == 2 else 6         # image 2: over the cap
        for _ in range(n_rand):
            w, h = rng.uniform(4, 30, 2)
            x0, y0 = rng.uniform(0, W - w), rng.uniform(0, H - h)
            boxes.append([x0, y0, x0 + w, y0 + h])
            scores.append(rng.uniform(0, 1))
            classes.append(int(rng.randint(0, 3)))
            masks.append(rasterize_polygons(
                [_polygon(rng, x0, y0, w, h, 5).ravel()], H, W))
            q = np.zeros((K, 3))
            q[:, 0] = rng.uniform(x0, x0 + w, K)
            q[:, 1] = rng.uniform(y0, y0 + h, K)
            q[:, 2] = rng.uniform(0, 1, K)
            kps.append(q)
        n = len(scores)
        valid = rng.rand(n) < 0.95
        gt[str(k)] = annos
        dets[str(k)] = (np.asarray(boxes, np.float32),
                        np.asarray(scores, np.float32),
                        np.asarray(classes, np.int32), valid,
                        np.stack(masks), np.asarray(kps, np.float32))
    return gt, dets


def _same(a, b):
    assert a.keys() == b.keys()
    for task in a:
        assert a[task].keys() == b[task].keys()
        for k in a[task]:
            x, y = a[task][k], b[task][k]
            assert (math.isnan(x) and math.isnan(y)) or x == y, (task, k, x,
                                                                 y)


def _run(mod, gt, dets, tasks, images=None):
    ev = mod.COCODetectionEvaluator(CLASSES, gt, tasks=tasks)
    ev.reset()
    for img in images or dets:
        boxes, scores, classes, valid, masks, kps = dets[img]
        kw = {}
        if "segm" in tasks:
            kw["masks"] = masks
        if "keypoints" in tasks:
            kw["keypoints"] = kps
        ev.process_single(img, boxes, scores, classes, valid, **kw)
    return ev


@pytest.mark.parametrize("tasks", [("bbox", "segm"), ("bbox", "keypoints"),
                                   ("bbox", "segm", "keypoints")])
@pytest.mark.parametrize("seed", [0, 1])
def test_dense_tasks_bit_equal(tasks, seed):
    gt, dets = _scene(seed)
    got = _run(pe, gt, dets, tasks).evaluate()
    want = _run(je, gt, dets, tasks).evaluate()
    _same(got, want)
    for t in tasks:
        assert 0 < got[t]["AP"] < 100 and 0 < got[t]["AP50"] <= 100


def test_perfect_detections_score_100():
    """Each GT detected by its own mask and keypoints alone: segm AP 100
    over the classes with GT, the class without GT left out (NaN)."""
    gt, dets = _scene(3, 3)
    perfect = {}
    for img, (boxes, scores, classes, valid, masks, kps) in dets.items():
        n = 2 * sum(1 for a in gt[img] if not a["iscrowd"])
        sl = slice(0, n, 2)
        kp = np.asarray([np.asarray(a["keypoints"]).reshape(K, 3)
                         for a in gt[img] if not a["iscrowd"]])
        perfect[img] = (boxes[sl], scores[sl], classes[sl],
                        np.ones(n // 2, bool), masks[sl], kp)
    tasks = ("bbox", "segm", "keypoints")
    got = _run(pe, gt, perfect, tasks).evaluate()
    _same(got, _run(je, gt, perfect, tasks).evaluate())
    assert got["segm"]["AP"] == 100.0 and got["keypoints"]["AP"] == 100.0


def test_merged_halves_equal_the_whole():
    gt, dets = _scene(4)
    tasks = ("bbox", "segm", "keypoints")
    whole = _run(pe, gt, dets, tasks).evaluate()
    imgs = sorted(dets)
    a = _run(pe, gt, dets, tasks, imgs[:3]).state_dict()
    b = _run(je, gt, dets, tasks, imgs[3:]).state_dict()
    for merge_into in (pe, je):
        ev = merge_into.COCODetectionEvaluator(CLASSES, gt, tasks=tasks)
        ev.merge_states([a, b])
        _same(ev.evaluate(), whole)


def test_helpers_bit_equal():
    rng = np.random.RandomState(5)
    for _ in range(5):
        m = rng.rand(13, 17) < 0.4
        m[0, 0] = rng.rand() < 0.5
        r = pe.rle_encode(m)
        assert r == je.rle_encode(m)
        np.testing.assert_array_equal(pe.rle_decode(r), m)
        assert pe.rle_area(r) == je.rle_area(r) == m.sum()
    assert pe.rle_encode(np.zeros((0, 4))) == je.rle_encode(np.zeros((0, 4)))
    poly = [_polygon(rng, 5, 5, 30, 20).ravel().tolist()]
    for seg in (poly, pe.rle_encode(m), {"size": [10, 12],
                                         "counts": [5, 30, 85]}):
        np.testing.assert_array_equal(pe.gt_segmentation_mask(seg, 13, 17),
                                      je.gt_segmentation_mask(seg, 13, 17))
    dm = [rng.rand(9, 9) < 0.5 for _ in range(4)]
    gm = [rng.rand(9, 9) < 0.5 for _ in range(3)] + [np.zeros((9, 9), bool)]
    np.testing.assert_array_equal(pe._mask_iou_matrix(dm, gm),
                                  je._mask_iou_matrix(dm, gm))
    dk, gk = rng.uniform(0, 50, (5, K, 3)), rng.uniform(0, 50, (3, K, 3))
    gk[..., 2] = rng.randint(0, 3, (3, K))
    gk[1, :, 2] = 0
    areas = rng.uniform(50, 900, 3)
    np.testing.assert_array_equal(
        pe._oks_matrix(dk, gk, areas, pe.COCO_KPT_SIGMAS),
        je._oks_matrix(dk, gk, areas, je.COCO_KPT_SIGMAS))
    np.testing.assert_array_equal(pe.COCO_KPT_SIGMAS, je.COCO_KPT_SIGMAS)


def test_compressed_rle_raises_in_both():
    """COCO writes crowd masks with compressed string counts; the JAX
    package's ``rle_decode`` iterates them as characters and raises."""
    rle = {"size": [4, 4], "counts": "52203"}
    for mod in (pe, je):
        with pytest.raises(TypeError):
            mod.rle_decode(rle)
        with pytest.raises(TypeError):
            mod.gt_segmentation_mask(rle, 4, 4)


def test_gt_class_without_detections_is_nan_in_dense_tasks():
    """A class with GT but no detection scores 0 box AP, but NaN in the
    dense tasks: their loop skips an image without detections of the
    class before it records a match (``_evaluate_dense_task``), as the
    JAX package's does, so the class has no AP."""
    gt, dets = _scene(6, 2)
    only_b = {img: tuple(v[d[2] == 1] for v in d)
              for img, d in dets.items()}
    for g in gt.values():
        for a in g:
            a["category_id"] = 0
    tasks = ("bbox", "segm", "keypoints")
    got = _run(pe, gt, only_b, tasks).evaluate()
    _same(got, _run(je, gt, only_b, tasks).evaluate())
    assert got["bbox"]["AP"] == 0.0
    assert math.isnan(got["segm"]["AP"]) and math.isnan(
        got["keypoints"]["AP"])
