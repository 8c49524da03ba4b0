"""RetinaNet against the JAX package, on the CPU: the anchors bit for bit;
the focal loss within rtol 1e-6; the toy model (R18-FPN 32, 5 classes,
the head's 256-wide towers, the same weights through ``params_from_jax``)
in float32: the dense logits and deltas within 1e-5 of the largest, the
losses within rtol 1e-5, and in bfloat16 within 2e-2 (a bf16 tower rounds
differently from XLA's); ``inference_scores``' candidate rows within 1e-6,
in the same order;
``make_detect_fn``'s keep sets equal to JAX's; 3 train steps against JAX
``make_train_step``; the build arm from both YAMLs on the meta device, the
optimizer's labels, and the Detectron2 import as the JAX package's.

The batch's GT boxes keep every anchor's IoU more than 1e-4 from the
matcher's 0.4 and 0.5, and each GT's best anchor 1e-4 above its second:
the port's IoU and the jitted JAX one may round to opposite sides of a
threshold or of a tie (ROADMAP.md section 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.models.proposal_generator import generate_anchors
from drn_wsod_torch.models.retinanet import sigmoid_focal_loss
from drn_wsod_torch.structures.boxes import pairwise_iou
from drn_wsod_tpu.evaluation.evaluator import make_detect_fn as jax_detect_fn
from drn_wsod_tpu.models import build_model as jax_build_model
from drn_wsod_tpu.models.proposal_generator import \
    generate_anchors as jax_anchors
from drn_wsod_tpu.models.retinanet import \
    sigmoid_focal_loss as jax_focal
from drn_wsod_tpu.solver.build import make_param_labels as jax_labels
from test_torch_common import (CONFIGS, cfg_pair, d2_state_dict, flatten,
                               jax_batch, param_shapes, random_params,
                               unflatten)
from test_torch_train_slice import _jax_steps, _port_steps

torch.set_num_threads(1)

INSTANT = str(CONFIGS / "quick_schedules" / "retinanet_R_50_instant_test.yaml")
FULL = str(CONFIGS / "COCO-Detection" / "retinanet_R_50_FPN_1x.yaml")
C = 5
TOY = ("MODEL.FPN.OUT_CHANNELS", 32, "MODEL.RETINANET.NUM_CLASSES", C,
       "MODEL.PIXEL_STD", [57.4, 57.1, 58.4])


def _batch(seed: int, size=(64, 64)) -> drn_wsod_torch.WSODBatch:
    """Two images of ``size`` (the second's valid part smaller), 3 GT
    slots (the last padded) away from the matcher's thresholds, each with
    one best anchor (the low-quality match takes every anchor tied at a
    GT's best IoU, and two IoUs equal in one rounding may not be in
    another), 4 empty proposal slots."""
    H, W = size
    rng = np.random.RandomState(seed)
    anchors = torch.cat([generate_anchors(
        (-(-H // s), -(-W // s)), s, sz, (0.5, 1.0, 2.0))
        for s, sz in ((8, (32, 40, 51)), (16, (64, 81, 102)),
                      (32, (128, 161, 203)), (64, (256, 323, 406)))])
    while True:
        xy = rng.uniform(0, [W * 0.5, H * 0.5], (2, 3, 2))
        wh = rng.uniform(12, 40, (2, 3, 2))
        gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        iou = pairwise_iou(torch.from_numpy(gt[:, :2]), anchors)
        top2 = iou.topk(2, dim=-1).values
        if all((iou - t).abs().min() > 1e-4 for t in (0.4, 0.5)) and \
                (top2[..., 0] - top2[..., 1]).min() > 1e-4:
            break
    return drn_wsod_torch.WSODBatch(
        image=torch.from_numpy(rng.uniform(0, 255, (2, H, W, 3))
                               .astype(np.float32)),
        image_hw=torch.tensor([[H, W], [H - 8, W - 4]], dtype=torch.int32),
        orig_hw=torch.tensor([[H * 2, W * 2], [H, W]], dtype=torch.int32),
        proposals=torch.zeros(2, 4, 4), proposal_mask=torch.zeros(
            2, 4, dtype=torch.bool), objectness=torch.zeros(2, 4),
        labels=torch.zeros(2, C), image_id=torch.arange(2, dtype=torch.int32),
        gt_boxes=torch.from_numpy(gt),
        gt_classes=torch.from_numpy(rng.randint(0, C, (2, 3))
                                    .astype(np.int32)),
        gt_valid=torch.tensor([[True, True, False]] * 2))


def _models(*overrides, yaml=INSTANT, seed=1):
    jc, pc = cfg_pair(*TOY, *overrides, yaml=yaml)
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(_batch(0)))), seed=seed)
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    return jm, flat, pm, jc, pc


@pytest.fixture(scope="module")
def f32():
    return _models("MODEL.DTYPE", "float32")


@pytest.mark.parametrize("hw,stride,sizes,ratios", [
    ((8, 8), 8, (32.0, 40.0, 51.0), (0.5, 1.0, 2.0)),
    ((5, 7), 16, (64.0, 81.0, 102.0), (0.5, 1.0, 2.0)),
    ((3, 1), 64, (256.0, 323.0, 406.0), (0.25, 1.0, 3.0, 0.7)),
    ((13, 17), 32, (33.3,), (1.0,))])
def test_anchors_bit_equal(hw, stride, sizes, ratios):
    got = generate_anchors(hw, stride, sizes, ratios).numpy()
    want = np.asarray(jax_anchors(hw, stride, sizes, ratios))
    assert got.shape == (hw[0] * hw[1] * len(sizes) * len(ratios), 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (-1.0, 2.0),
                                         (0.5, 0.0), (0.25, 1.5)])
def test_focal_loss(alpha, gamma):
    rng = np.random.RandomState(3)
    x = (rng.randn(500, 7) * 4).astype(np.float32)
    t = (rng.rand(500, 7) < 0.2).astype(np.float32)
    got = sigmoid_focal_loss(torch.from_numpy(x), torch.from_numpy(t),
                             alpha, gamma).numpy()
    want = np.asarray(jax_focal(jnp.asarray(x), jnp.asarray(t), alpha, gamma))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


def _jax_dense(jm, flat, batch):
    def fn(mdl, image):
        return mdl._forward_dense(image)[:3]
    return [np.asarray(a) for a in jm.apply(
        {"params": unflatten(flat)}, jnp.asarray(batch.image.numpy()),
        method=fn)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_dense_outputs_and_losses(dtype, tol):
    jm, flat, pm, _, _ = _models("MODEL.DTYPE", dtype)
    b = _batch(1)
    lg, dl, an = _jax_dense(jm, flat, b)
    with torch.no_grad():
        plg, pdl, pan, sizes = pm.dense(pm.features(b.image))
    np.testing.assert_array_equal(pan.numpy(), an)
    assert sizes == [8 * 8 * 9, 4 * 4 * 9, 2 * 2 * 9, 9]
    for got, want in ((plg, lg), (pdl, dl)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())
    want = jm.apply({"params": unflatten(flat)}, jax_batch(b), train=True)
    got = pm(b, train=True)
    assert set(got) == set(want) == {"loss_cls", "loss_box_reg"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=tol)


def test_no_gt_gives_zero_box_loss(f32):
    _, _, pm, _, _ = f32
    b = _batch(2)
    b = b.replace(gt_valid=torch.zeros_like(b.gt_valid))
    losses = pm(b, train=True)
    assert losses["loss_box_reg"].item() == 0.0
    assert losses["loss_cls"].item() > 0


def test_inference_scores(f32):
    jm, flat, pm, _, _ = f32
    pm.topk_candidates = 50
    try:
        b = _batch(3, (96, 80))
        want_s, want_b = jm.clone(topk_candidates=50).apply(
            {"params": unflatten(flat)}, jax_batch(b),
            method="inference_scores")
        got_s, got_b = pm.inference_scores(b)
    finally:
        pm.topk_candidates = 1000
    want_s, want_b = np.asarray(want_s), np.asarray(want_b)
    # K = sum of min(50, n) over levels (12x10, 6x5, 3x2, 2x1 cells x 9)
    assert got_s.shape == want_s.shape == (2, 50 + 50 + 50 + 18, C + 1)
    assert (got_s[..., -1] == 0).all()
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=1e-5, atol=1e-3)


def test_detect_keep_sets(f32):
    """Every candidate is live (RetinaNet's K rows are not the batch's 4
    proposal slots); the kept detections equal JAX's."""
    jm, flat, pm, _, _ = f32
    b = _batch(4)
    jdet = jax_detect_fn(jm, -1.0, 0.5, 20)(
        {"params": unflatten(flat)}, jax_batch(b))
    pdet = drn_wsod_torch.make_detect_fn(pm, -1.0, 0.5, 20,
                                         device="cpu")(b)
    np.testing.assert_array_equal(pdet["valid"].numpy(),
                                  np.asarray(jdet["valid"]))
    assert pdet["valid"].all()
    np.testing.assert_array_equal(pdet["classes"].numpy(),
                                  np.asarray(jdet["classes"]))
    np.testing.assert_allclose(pdet["scores"].numpy(),
                               np.asarray(jdet["scores"]), atol=1e-6)
    np.testing.assert_allclose(pdet["boxes"].numpy(),
                               np.asarray(jdet["boxes"]), atol=2e-3)


def test_train_steps_match_jax(f32):
    jm, flat, _, jc, pc = f32
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    batches = [_batch(10 + s) for s in range(3)]
    jax_state, jax_metrics = _jax_steps(jm, flat, jc, batches)
    port_state, port_metrics = _port_steps(pm, pc, batches)
    for want, got in zip(jax_metrics, port_metrics):
        assert set(got) == set(want) == {"loss_cls", "loss_box_reg",
                                         "total_loss"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    want = flatten(jax_state.params["params"])
    got = drn_wsod_torch.params_from_jax(
        {k: np.asarray(v) for k, v in want.items()})
    sd = port_state.model.state_dict()
    for k, v in got.items():
        np.testing.assert_allclose(sd[k].float().numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("yaml", [INSTANT, FULL])
def test_build_arm(yaml):
    """Both YAMLs build on the meta device: the RetinaNet arm with p3-p6,
    9 anchors a cell, 80 classes; their parameter labels under FREEZE_AT 2
    are the JAX package's."""
    jc, pc = cfg_pair(yaml=yaml)
    pm = drn_wsod_torch.build_model(pc, device="meta")
    assert type(pm).__name__ == "RetinaNet"
    assert pm.in_features == ("p3", "p4", "p5", "p6")
    assert pm.strides == (8, 16, 32, 64)
    assert pm.head.cls_score.out_channels == 9 * 80
    assert pm.head.bbox_pred.out_channels == 9 * 4
    assert pc.MODEL.BACKBONE.FREEZE_AT == 2
    jm = jax_build_model(jc)
    b = _batch(0)
    shapes = param_shapes(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jax_batch(b)))
    want = flatten(jax_labels(unflatten({k: np.zeros(1) for k in shapes}),
                              2))
    from drn_wsod_torch.checkpoint.from_jax import port_name
    from drn_wsod_torch.solver.build import make_param_labels
    labels = make_param_labels([n for n, _ in pm.named_parameters()], 2)
    want = {port_name(k): v for k, v in want.items()}
    assert {n: want[n] for n in labels} == labels
    assert set(labels.values()) == {"weight", "bias"}   # FPN: all train
    shapes = {port_name(k): s for k, s in shapes.items()}
    for n, p in pm.named_parameters():
        assert shapes[n] == (tuple(p.shape) if p.dim() != 4 else tuple(
            p.shape[2:]) + (p.shape[1], p.shape[0])), n
    # the FrozenBN statistics are the port's buffers
    assert set(shapes) == set(pm.state_dict())


def test_anchor_sizes_per_feature_assert():
    jc, pc = cfg_pair("MODEL.ANCHOR_GENERATOR.SIZES", [[32.0], [64.0]],
                      yaml=INSTANT)
    with pytest.raises(AssertionError, match="one size group"):
        jax_build_model(jc)
    with pytest.raises(AssertionError, match="one size group"):
        drn_wsod_torch.build_model(pc, device="meta")


def test_detectron2_import_as_jax(f32, tmp_path):
    """A Detectron2 RetinaNet checkpoint (Sequential tower indices 0, 2,
    4, 6) loads into both packages alike: the JAX name map reaches
    ``head.cls_score``, ``head.bbox_pred`` and the bottom-up backbone but
    not the towers (``head.cls_subnet.0`` maps to flax
    ``head.cls_subnet.0``, not ``cls_subnet_0``) nor the FPN convs, so both
    keep those at their values."""
    import pickle

    from drn_wsod_tpu.checkpoint.torch_import import \
        load_reference_weights as jax_load

    jm, flat, pm, _, pc = f32
    donor = drn_wsod_torch.build_model(
        pc, device="cpu", generator=torch.Generator().manual_seed(7))
    path = tmp_path / "retinanet.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": d2_state_dict(donor.state_dict())}, f)
    jvars = jax_load(str(path), {"params": unflatten(flat)})
    unmatched, _ = drn_wsod_torch.load_reference_weights(str(path), pm)
    assert any(n.startswith("head.cls_subnet.") for n in unmatched)
    want = drn_wsod_torch.params_from_jax(
        {k: np.asarray(v) for k, v in flatten(jvars["params"]).items()})
    got = pm.state_dict()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    sd = donor.state_dict()
    assert torch.equal(got["head.cls_score.weight"],
                       sd["head.cls_score.weight"])
    assert not torch.equal(got["head.cls_subnet.0.weight"],
                           sd["head.cls_subnet.0.weight"])
