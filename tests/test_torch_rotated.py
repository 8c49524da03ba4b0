"""Rotated boxes against the JAX package, on the CPU.

Torch's ``cos`` and ``sin`` differ from XLA's by an ulp on about one angle
in twenty, and XLA contracts some multiply-adds, so the corners agree
within 4 float32 ulps of the box's largest input (its centre or sides)
and the IoUs within 1e-6; the JAX functions run jitted, as the JAX
package runs them. The
pairs: identical, disjoint, one inside the other, a square against itself
turned 90 degrees, near-parallel, sharing a corner, and random ones. A
chunked IoU equals the unchunked one bit for bit (the chunk only splits
the pairs), and so does the IoU of pairs far apart, which are skipped.
NMS keeps what the JAX function keeps where no IoU lies within 1e-5 of
the threshold; the deltas round trip; the host IoU and the rotated COCO
evaluator are numpy in both packages and agree bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.evaluation import rotated_coco_eval as preval
from drn_wsod_torch.structures import rotated_boxes as prot
from drn_wsod_tpu.evaluation import rotated_coco_eval as jreval
from drn_wsod_tpu.structures import rotated_boxes as jrot

torch.set_num_threads(1)

IOU_ATOL = 1e-6
CORNER_ULPS = 4


def _random_boxes(rs, n, lo=0.0, hi=120.0):
    return np.stack([rs.uniform(lo, hi, n), rs.uniform(lo, hi, n),
                     rs.uniform(4, 50, n), rs.uniform(4, 50, n),
                     rs.uniform(-180, 180, n)], -1).astype(np.float32)


def _special_pairs():
    """(A, B) row pairs of the named cases."""
    pairs = [
        ([30, 30, 20, 10, 25], [30, 30, 20, 10, 25]),        # identical
        ([10, 10, 8, 6, 30], [100, 100, 8, 6, -15]),         # disjoint
        ([50, 50, 40, 30, 10], [52, 49, 10, 8, 40]),         # contained
        ([40, 40, 16, 16, 0], [40, 40, 16, 16, 90]),         # 90 symmetric
        ([60, 60, 40, 6, 0], [60, 63, 40, 6, 0.5]),          # near-parallel
        ([10, 10, 10, 10, 0], [20, 20, 10, 10, 0]),          # shared corner
        ([5, 5, 10, 10, 0], [10, 5, 10, 10, 0]),             # half overlap
        ([70, 20, 30, 12, -60], [72, 22, 30, 12, 120]),      # turned 180
    ]
    a = np.array([p[0] for p in pairs], np.float32)
    b = np.array([p[1] for p in pairs], np.float32)
    return a, b


@pytest.fixture(scope="module")
def boxes():
    rs = np.random.RandomState(0)
    a, b = _special_pairs()
    a = np.concatenate([a, _random_boxes(rs, 40)])
    b = np.concatenate([b, _random_boxes(rs, 32)])
    want = np.asarray(jax.jit(jrot.pairwise_iou_rotated)(a, b))
    return a, b, want


def test_corners_match_jax(boxes):
    a, b, _ = boxes
    x = np.concatenate([a, b])
    want = np.asarray(jax.jit(jrot.rotated_to_corners)(x))
    got = prot.rotated_to_corners(torch.from_numpy(x)).numpy()
    ulp = np.spacing(np.abs(x[:, :4]).max(1))[:, None, None]
    assert (np.abs(got - want) <= CORNER_ULPS * ulp).all()


def test_iou_matches_jax(boxes):
    a, b, want = boxes
    got = prot.pairwise_iou_rotated(torch.from_numpy(a),
                                    torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL)
    d = np.diag(got[:8, :8])
    np.testing.assert_allclose(d[[0, 3]], 1.0, atol=1e-6)    # same box
    assert d[1] == 0.0 and d[5] == 0.0                         # no area
    np.testing.assert_allclose(d[2], 80.0 / 1200.0, rtol=1e-5)
    np.testing.assert_allclose(d[6], 50.0 / 150.0, rtol=1e-5)
    np.testing.assert_allclose(d[7], got[7, 7], rtol=0)
    assert (got > 0).sum() > 20
    # the float64 host clip agrees to float32 rounding
    host = preval.iou_matrix_rotated(a.astype(np.float64),
                                     b.astype(np.float64))
    np.testing.assert_allclose(got, host, rtol=0, atol=2e-6)


@pytest.mark.parametrize("chunk", [1, 7, 1 << 20])
def test_chunked_iou_equals_unchunked(boxes, chunk):
    a, b, _ = boxes
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    whole = prot.pairwise_iou_rotated(ta, tb)
    assert torch.equal(prot.pairwise_iou_rotated(ta, tb, chunk=chunk), whole)
    # every pair through the convex formula, none skipped as far apart
    ca, cb = prot.rotated_to_corners(ta), prot.rotated_to_corners(tb)
    n, m = len(a), len(b)
    inter = prot.convex_intersection_area(
        ca[:, None].expand(n, m, 4, 2), cb[None].expand(n, m, 4, 2))
    union = ta[:, 2:3] * ta[:, 3:4] + (tb[:, 2] * tb[:, 3])[None] - inter
    full = torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)
    assert torch.equal(full, whole)


def test_degenerate_box_iou_is_jax_jitted():
    """A box whose short side rounds away (a decoded proposal's 5.3e-13)
    has zero-length edges: its IoU is 0, as the jitted JAX function and
    the float64 clip give (the JAX function op by op gives 7.5e6)."""
    a = np.array([[1216.0, 0.0, 16000.0009765625, 5.333585136046981e-13,
                   34.583984375]], np.float32)
    b = np.array([[1030.0804443359375, 498.4395446777344, 333.7973327636719,
                   351.75103759765625, -13.913498878479004]], np.float32)
    want = np.asarray(jax.jit(jrot.pairwise_iou_rotated)(a, b))
    got = prot.pairwise_iou_rotated(torch.from_numpy(a), torch.from_numpy(b))
    assert want[0, 0] == 0.0 and float(got) == 0.0
    assert preval.iou_matrix_rotated(a.astype(np.float64),
                                     b.astype(np.float64))[0, 0] == 0.0
    corners = prot.rotated_to_corners(torch.from_numpy(a))
    assert torch.equal(corners[0, 0], corners[0, 3])     # a zero-length edge


def test_box_helpers_match_jax():
    """``pairwise_intersection``, ``pairwise_iou_wsl`` (containing,
    contained, disjoint and overlapping pairs) and ``nonempty`` bit for
    bit, op by op as the JAX functions compute them; ``Detections`` holds
    the JAX dataclass's fields."""
    import dataclasses

    from drn_wsod_torch.structures import Detections, boxes as pboxes
    from drn_wsod_tpu.structures import Detections as JaxDetections
    from drn_wsod_tpu.structures import boxes as jboxes

    rs = np.random.RandomState(5)
    xy = rs.uniform(0, 60, (24, 2))
    a = np.concatenate([xy, xy + rs.uniform(0, 30, (24, 2))], 1)
    a[:3] = [[10, 10, 40, 40], [15, 15, 20, 20], [50, 50, 50, 60]]
    b = np.concatenate([a[:6] + [[-2, -2, 2, 2]], a[6:12] + 200.0], 0)
    a, b = a.astype(np.float32), b.astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    with jax.disable_jit():
        for fn in ("pairwise_intersection", "pairwise_iou_wsl"):
            want = np.asarray(getattr(jboxes, fn)(a, b))
            got = getattr(pboxes, fn)(ta, tb).numpy()
            assert np.array_equal(got, want), fn
        assert np.array_equal(pboxes.nonempty(ta, 1.0).numpy(),
                              np.asarray(jboxes.nonempty(a, 1.0)))
    wsl = pboxes.pairwise_iou_wsl(ta, tb).numpy()
    assert (wsl < 0).any() and (wsl == 1.0).any()
    assert [f.name for f in dataclasses.fields(Detections)] == \
        [f.name for f in dataclasses.fields(JaxDetections)]


def test_iou_of_empty_sets():
    z = torch.zeros((0, 5))
    assert prot.pairwise_iou_rotated(z, torch.ones((3, 5))).shape == (0, 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_rotated_keeps_what_jax_keeps(seed):
    rs = np.random.RandomState(seed)
    centres = _random_boxes(rs, 6, 20, 100)
    x = np.concatenate([centres + np.concatenate([
        rs.uniform(-4, 4, (6, 2)), rs.uniform(-3, 3, (6, 2)),
        rs.uniform(-20, 20, (6, 1))], 1) for _ in range(5)]).astype(
            np.float32)
    scores = rs.uniform(0, 1, len(x)).astype(np.float32)
    valid = rs.uniform(0, 1, len(x)) > 0.1
    thr = 0.5
    iou = prot.pairwise_iou_rotated(torch.from_numpy(x), torch.from_numpy(x))
    assert ((iou - thr).abs() > 1e-5).all()
    want = np.asarray(jax.jit(jrot.nms_rotated, static_argnums=3)(
        x, scores, valid, thr))
    got = prot.nms_rotated(torch.from_numpy(x), torch.from_numpy(scores),
                           torch.from_numpy(valid), thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum()


def test_deltas_match_jax_and_round_trip():
    rs = np.random.RandomState(3)
    src = _random_boxes(rs, 64, 20, 80)
    tgt = _random_boxes(rs, 64, 20, 80)
    weights = (10.0, 10.0, 5.0, 5.0, 1.0)
    for w in ((1.0,) * 5, weights):
        want = np.asarray(jax.jit(jrot.get_deltas_rotated, static_argnums=2)(
            src, tgt, w))
        got = prot.get_deltas_rotated(torch.from_numpy(src),
                                      torch.from_numpy(tgt), w)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        back_want = np.asarray(jax.jit(jrot.apply_deltas_rotated,
                                       static_argnums=2)(want, src, w))
        back = prot.apply_deltas_rotated(got, torch.from_numpy(src), w)
        np.testing.assert_allclose(back.numpy(), back_want, rtol=1e-6,
                                   atol=2e-5)
        np.testing.assert_allclose(back.numpy()[:, :4], tgt[:, :4],
                                   rtol=1e-4, atol=1e-3)
        da = (back.numpy()[:, 4] - tgt[:, 4] + 180.0) % 360.0 - 180.0
        np.testing.assert_allclose(da, 0.0, atol=1e-3)
    # (..., K*5) deltas against (..., 5) boxes, and the scale clamp
    d = torch.from_numpy(rs.normal(0, 3, (4, 64, 10)).astype(np.float32))
    b = torch.from_numpy(src)[None].expand(4, 64, 5)
    want = np.asarray(jrot.apply_deltas_rotated(jnp.asarray(d.numpy()),
                                                jnp.asarray(b.numpy())))
    np.testing.assert_allclose(prot.apply_deltas_rotated(d, b).numpy(), want,
                               rtol=1e-5, atol=2e-5)


def test_host_iou_bit_equal_to_jax():
    rs = np.random.RandomState(4)
    a, b = _special_pairs()
    det = np.concatenate([a, _random_boxes(rs, 20)]).astype(np.float64)
    gt = np.concatenate([b, _random_boxes(rs, 15)]).astype(np.float64)
    assert np.array_equal(preval.rotated_corners_np(det),
                          jreval.rotated_corners_np(det))
    got = preval.iou_matrix_rotated(det, gt)
    assert np.array_equal(got, jreval.iou_matrix_rotated(det, gt))
    assert preval.iou_matrix_rotated(det[:0], gt).shape == (0, len(gt))


@pytest.mark.parametrize("seed", [0, 1])
def test_rotated_evaluator_bit_equal_to_jax(seed):
    rs = np.random.RandomState(seed)
    gt, dets = {}, {}
    for i in range(5):
        boxes = _random_boxes(rs, rs.randint(0, 5)).astype(np.float64)
        gt[str(i)] = [{"category_id": int(rs.randint(0, 3)),
                       "bbox": [float(v) for v in bx],
                       "difficult": int(rs.uniform() < 0.15)}
                      for bx in boxes]
        jit = boxes + np.concatenate([rs.uniform(-3, 3, (len(boxes), 4)),
                                      rs.uniform(-10, 10, (len(boxes), 1))],
                                     1)
        extra = _random_boxes(rs, 3).astype(np.float64)
        d = np.concatenate([jit, extra])
        cls = np.concatenate([[a["category_id"] for a in gt[str(i)]],
                              rs.randint(0, 3, 3)]).astype(np.int64)
        dets[str(i)] = (d, rs.uniform(0, 1, len(d)), cls,
                        rs.uniform(0, 1, len(d)) > 0.1)
    names = ["a", "b", "c"]
    evs = [preval.RotatedCOCODetectionEvaluator(names, gt),
           jreval.RotatedCOCODetectionEvaluator(names, gt)]
    for ev in evs:
        for image_id, d in dets.items():
            ev.process_single(image_id, *d)
    got, want = evs[0].evaluate(), evs[1].evaluate()
    assert got.keys() == want.keys() == {"bbox"}
    for k, w in want["bbox"].items():
        g = got["bbox"][k]
        assert (np.isnan(g) and np.isnan(w)) or g == w, (k, g, w)
    assert np.isfinite(got["bbox"]["AP"])
