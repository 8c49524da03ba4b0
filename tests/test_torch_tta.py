"""The port's TTA (``drn_wsod_torch/tta.py``, ``ops/resize.py``,
``ops/nms.py:nms_mask``) against the JAX package's ``tta.py``, on the CPU,
with the toy flagship config (R18, DAN [64, 64], P = 64, float32) and the
same weights through ``params_from_jax``.

Tolerances:
- ``scale_linear`` against ``jax.image.scale_and_translate(..., "linear",
  antialias=True)``: atol 2e-3 on 0-255 pixels (float32; the two sum the
  weight columns and contract the two products in different orders);
  its weight matrices against ``compute_weight_mat``: atol 1e-6;
- the device-built views' images against JAX's: the same 2e-3;
- view proposals, masks, objectness, sizes and inverse info (both paths),
  the host-built images, ``_invert_boxes`` and ``nms_mask``: bit-equal;
- TTA scores and boxes (``GeneralizedRCNNWithTTAAVG``, ``make_tta_detect_fn``,
  ``make_tta_union_detect_fn``): ``tests/test_torch_slice.py``'s rtol 1e-4
  and atol 1e-5 times the largest value compared; classes and boxes equal
  wherever a score is further from its neighbours than that."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image.scale import compute_weight_mat

import drn_wsod_torch
from drn_wsod_torch import tta as ptta
from drn_wsod_torch.models import meta_arch
from drn_wsod_torch.ops.nms import nms_mask
from drn_wsod_torch.ops.resize import scale_linear, weight_mat
from drn_wsod_tpu import tta as jtta
from drn_wsod_tpu.models import build_model as jax_build_model
from drn_wsod_tpu.ops.nms import nms_mask as jax_nms_mask
from test_torch_common import (TOY, assert_detections_match, cfg_pair,
                               jax_batch, param_shapes, random_params,
                               unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
PIXEL_ATOL = 2e-3
H0, W0 = 45, 61
# views of a 45x61 image: 40 -> (40, 54) in bucket 64, 72 -> (72, 98)
# rounded up to bucket 128
TTA = ("TEST.AUG.MIN_SIZES", (40, 72), "TEST.AUG.MAX_SIZE", 200,
       "INPUT.BUCKETS", [64, 96])
CASES = {
    "oicr_refine_reg": ("WSL.REFINE_REG", [False, False, True]),
    "wsddn": ("MODEL.ROI_HEADS.NAME", "WSDDNROIHeads"),
    "oicr": (),
}


def _image(seed=0, h=H0, w=W0):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)


def _proposals(n, seed=1, h=H0, w=W0):
    """(n, 4) float32 boxes inside the image, some duplicated; (n,) logits
    in descending order."""
    rs = np.random.RandomState(seed)
    x1 = rs.uniform(0, w - 10, n)
    y1 = rs.uniform(0, h - 10, n)
    b = np.stack([x1, y1, np.minimum(x1 + rs.uniform(4, 40, n), w - 1),
                  np.minimum(y1 + rs.uniform(4, 30, n), h - 1)], 1)
    b = b.astype(np.float32)
    b[n // 2:n // 2 + 4] = b[:4]
    return b, np.sort(rs.uniform(-1, 1, n).astype(np.float32))[::-1].copy()


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request, tmp_path_factory):
    """(case, JAX cfg, port cfg, JAX model, JAX variables, port model,
    a JPEG record)."""
    from PIL import Image

    jc, pc = cfg_pair(*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4], *TTA,
                      *CASES[request.param])
    init = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, 20, seed=3,
                                          device="cpu")
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(init), train=False)),
        seed=1)
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    path = tmp_path_factory.mktemp("tta") / "im.jpg"
    Image.fromarray(_image()).save(path, quality=92)
    boxes, logits = _proposals(80)
    record = {"file_name": str(path), "proposal_boxes": boxes,
              "proposal_objectness_logits": logits, "height": H0, "width": W0,
              "annotations": [{"category_id": 3, "bbox": [2.0, 3.0, 30.0, 40.0],
                               "difficult": 0}]}
    return (request.param, jc, pc, jm, {"params": unflatten(flat)}, pm,
            record)


@pytest.mark.parametrize("in_size,out_size,scale", [
    (256, 64, 0.37), (256, 128, 0.5), (64, 64, 1.0), (64, 160, 2.3),
    (61, 128, 1.7), (45, 96, 3.1)])
def test_weight_mat_matches_jax(in_size, out_size, scale):
    s = np.float32(scale)
    want = np.asarray(compute_weight_mat(
        in_size, out_size, jnp.float32(s), jnp.float32(0),
        lambda x: jnp.maximum(0, 1 - jnp.abs(x)), True))
    got = weight_mat(in_size, out_size, torch.tensor(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got.sum(0)[want.sum(0) > 0] > 0.999).all()


@pytest.mark.parametrize("sy,sx,out", [(0.37, 0.55, 96), (1.0, 1.0, 64),
                                       (2.3, 1.7, 160), (0.9, 3.1, 128)],
                         ids=["down", "identity", "up", "mixed"])
def test_scale_linear_matches_jax(sy, sx, out):
    raw = np.random.RandomState(4).uniform(0, 255, (64, 64, 3)).astype(
        np.float32)
    sy, sx = np.float32(sy), np.float32(sx)
    want = np.asarray(jax.jit(lambda x, s: jax.image.scale_and_translate(
        x, (out, out, 3), (0, 1), s, jnp.zeros((2,), jnp.float32), "linear",
        antialias=True))(jnp.asarray(raw), jnp.asarray([sy, sx])))
    got = scale_linear(torch.from_numpy(raw), (out, out), torch.tensor(sy),
                       torch.tensor(sx)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PIXEL_ATOL)
    assert (want[:8, :8] > 0).all()


def _views(min_sizes=(40, 72), max_size=200):
    return jtta.enumerate_views((H0, W0), min_sizes, max_size, True)


@pytest.mark.parametrize("bucket,views", [(128, slice(None)),
                                          (64, slice(0, 2)),
                                          (128, slice(2, 4))],
                         ids=["all_in_128", "group_64", "group_128"])
def test_device_view_batch_matches_jax(bucket, views):
    image = _image(2)
    P, n = 64, 40
    b, logits = _proposals(n, seed=5)
    boxes = np.zeros((P, 4), np.float32)
    boxes[:n] = b
    mask = np.zeros((P,), bool)
    mask[:n] = True
    obj = np.zeros((P,), np.float32)
    obj[:n] = logits
    labels = np.zeros(20, np.float32)
    labels[[3, 7]] = 1
    rb = 256
    raw = np.pad(image, ((0, rb - H0), (0, rb - W0), (0, 0)), mode="edge")
    vs = _views()[views]
    flips = tuple(bool(f) for _, _, f in vs)
    new_hw = [(nh, nw) for nh, nw, _ in vs]
    want_b, want_inv = jax.jit(
        lambda r, hw0, nhw, bx, m, o, lab: jtta._device_view_batch(
            r, hw0, nhw, flips, bucket, bx, m, o, lab))(
        jnp.asarray(raw), jnp.asarray([H0, W0], jnp.int32),
        jnp.asarray(new_hw, jnp.int32), jnp.asarray(boxes),
        jnp.asarray(mask), jnp.asarray(obj), jnp.asarray(labels))
    t = torch.from_numpy
    got_b, got_inv = ptta._device_view_batch(
        t(raw), (H0, W0), new_hw, flips, bucket, t(boxes), t(mask), t(obj),
        t(labels))
    np.testing.assert_allclose(got_b.image.numpy(),
                               np.asarray(want_b.image), rtol=0,
                               atol=PIXEL_ATOL)
    for k in ("image_hw", "orig_hw", "proposals", "proposal_mask",
              "objectness", "labels", "image_id"):
        got, want = getattr(got_b, k).numpy(), np.asarray(getattr(want_b, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for k in ("scale", "flip", "width"):
        np.testing.assert_array_equal(got_inv[k].numpy(),
                                      np.asarray(want_inv[k]), err_msg=k)
    assert (got_b.proposals[:, n:] == 0).all()
    assert got_inv["flip"].tolist() == [float(f) for f in flips]


def test_host_view_batch_matches_jax():
    image = _image(3)
    boxes, logits = _proposals(70, seed=6)
    labels = np.eye(20, dtype=np.float32)[4]
    args = (image, boxes, logits, labels, (40, 72), 200, True, (64, 96), 64)
    for views in (None, _views()[2:]):
        got_b, got_inv = ptta.build_view_batch(*args, views=views)
        want_b, want_inv = jtta.build_view_batch(*args, views=views)
        for k in got_b.tensors():
            got, want = getattr(got_b, k).numpy(), np.asarray(
                getattr(want_b, k))
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
        for k in want_inv:
            np.testing.assert_array_equal(got_inv[k].numpy(),
                                          np.asarray(want_inv[k]))
    assert got_b.image.shape == (2, 128, 128, 3)


def test_invert_boxes_matches_jax():
    rs = np.random.RandomState(7)
    V, P = 4, 33
    boxes = rs.uniform(0, 150, (V, P, 4)).astype(np.float32)
    inv = {"scale": rs.uniform(0.3, 3, (V, 2)).astype(np.float32),
           "flip": np.array([0, 1, 0, 1], np.float32),
           "width": rs.randint(40, 160, V).astype(np.float32)}
    want = np.asarray(jax.jit(jtta._invert_boxes)(
        jnp.asarray(boxes), {k: jnp.asarray(v) for k, v in inv.items()}))
    got = ptta._invert_boxes(torch.from_numpy(boxes),
                             {k: torch.from_numpy(v) for k, v in inv.items()})
    np.testing.assert_array_equal(got.numpy(), want)


def test_nms_mask_matches_jax():
    rs = np.random.RandomState(8)
    N, C = 48, 5
    xy = rs.uniform(0, 60, (N, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(5, 40, (N, 2))], 1).astype(
        np.float32)
    scores = np.round(rs.uniform(0, 1, (C, N)), 1).astype(np.float32)  # ties
    valid = rs.uniform(size=(C, N)) < 0.8
    got = nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                   torch.from_numpy(valid), 0.3).numpy()
    for c in range(C):
        want = np.asarray(jax_nms_mask(jnp.asarray(boxes),
                                       jnp.asarray(scores[c]),
                                       jnp.asarray(valid[c]), 0.3))
        np.testing.assert_array_equal(got[c], want)
    assert 0 < got.sum() < valid.sum()


@pytest.mark.parametrize("device_views", [True, False],
                         ids=["device_views", "host_views"])
def test_tta_avg_matches_jax(pair, device_views):
    case, jc, pc, jm, variables, pm, record = pair
    jc, pc = jc.clone(), pc.clone()
    jc.TEST.AUG.DEVICE_VIEWS = pc.TEST.AUG.DEVICE_VIEWS = device_views
    want = jtta.GeneralizedRCNNWithTTAAVG(jc, jm, variables)(record)
    got = ptta.GeneralizedRCNNWithTTAAVG(pc, pm, device="cpu")(record)
    assert got.keys() == set(want)
    for k in ("all_scores", "all_boxes"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max(), err_msg=k)
    assert (got["all_boxes"].ndim == 3) == (case == "oicr_refine_reg")
    topk = pc.TEST.DETECTIONS_PER_IMAGE
    assert_detections_match(got, want, RTOL, ATOL, topk // 2)


def test_one_pool_call_per_group(pair, monkeypatch):
    """Each bucket group is one batch through the model: one pool call with
    B = the group's views (2 in bucket 64, 2 in bucket 128)."""
    *_, pc, _, _, pm, record = pair[1:]
    calls = []
    pool = meta_arch.roi_pool_batched

    def counting(feats, *args):
        calls.append(tuple(feats.shape[:3]))
        return pool(feats, *args)

    monkeypatch.setattr(meta_arch, "roi_pool_batched", counting)
    tta = ptta.GeneralizedRCNNWithTTAAVG(pc, pm, device="cpu")
    tta(record)
    assert [list(g) for g in tta.groups((H0, W0)).values()] == \
        [list(v) for v in (_views()[:2], _views()[2:])]
    assert [c[0] for c in calls] == [2, 2]
    assert calls[0][1:] < calls[1][1:]


def test_tta_detect_fns_match_jax(pair):
    case, jc, pc, jm, variables, pm, record = pair
    image = _image()
    boxes, logits = record["proposal_boxes"][:60], \
        record["proposal_objectness_logits"][:60]
    labels = np.eye(20, dtype=np.float32)[3]
    batch, inv = ptta.build_view_batch(image, boxes, logits, labels,
                                       (40, 72), 200, True, (64, 96), 64)
    jb = jax_batch(batch)
    jinv = {k: jnp.asarray(v.numpy()) for k, v in inv.items()}
    fns = [("avg", ptta.make_tta_detect_fn, jtta.make_tta_detect_fn)]
    if case != "oicr_refine_reg":          # the union takes 4-column boxes
        fns.append(("union", ptta.make_tta_union_detect_fn,
                    jtta.make_tta_union_detect_fn))
    for name, port_fn, jax_fn in fns:
        want = jax_fn(jm, 1e-5, 0.3, 50)(variables, jb, jinv)
        got = port_fn(pm, 1e-5, 0.3, 50, device="cpu")(batch, inv)
        got = {k: v.numpy() for k, v in got.items()}
        assert got.keys() == set(want), name
        for k in ("all_scores", "all_boxes"):
            if k in got:
                w = np.asarray(want[k])
                np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                           atol=ATOL * np.abs(w).max(),
                                           err_msg=f"{name} {k}")
        assert_detections_match(got, want, RTOL, ATOL, 20)
