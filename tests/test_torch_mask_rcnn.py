"""The mask and keypoint arms of the supervised heads against the JAX
package, on the CPU: Fast R-CNN with the Mask R-CNN and Keypoint R-CNN
heads, and Cascade R-CNN with the mask head (on its stage-0 sample).

  * the mask targets: the port pools an image's G masks as the channels of
    one map and takes each box's matched channel; that equals, bit for bit,
    the JAX package's RoIAlign of each box's own mask;
  * 3 train steps of the toy config (R18, DAN [64, 64], float32, dropout
    0, the same weights through ``params_from_jax``; the heads' pools at
    4 x 4, so the heads run at 8 x 8 and 16 x 16) against the JAX
    ``make_train_step``, on the batches of ``tests/test_torch_supervised.py``
    (13 valid proposals fill the 16 slots whatever the keys) with polygon
    masks and 17 keypoints (visibility 0, 1 or 2, some outside their box)
    per GT: every loss at every step and the trained parameters within rtol
    1e-4, atol 1e-5, as the other trajectories; Fast R-CNN at ``FREEZE_AT``
    2 (the differentiable pool, res3-res5 trained) and 5, Cascade at 2;
  * ``make_detect_fn`` with both arms against the JAX one: the detections
    as ``tests/test_torch_eval_slice.py`` holds them, ``mask_probs`` within
    the same tolerance, the keypoints' scores everywhere, and their (x, y)
    wherever the heatmap's two largest logits are more than 1e-4 apart (an
    argmax between two cells closer than that may go either way under a
    1e-6 difference of the logits); at least 80% of them are so decided;
  * ``build_model``: which heads each ROI head builds, and the optimizer's
    labels of the new parameters, as the JAX package's.
"""

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.structures.masks import fill_polygon
from drn_wsod_tpu.evaluation.evaluator import make_detect_fn as jax_detect_fn
from drn_wsod_tpu.models import build_model as jax_build_model
from drn_wsod_tpu.ops.roi_align import roi_align as jax_roi_align
from drn_wsod_tpu.solver.build import make_param_labels as jax_labels
from test_torch_common import (TOY, assert_detections_match, cfg_pair,
                               flatten, jax_batch, param_shapes,
                               random_params, unflatten)
from test_torch_supervised import _gt_batch
from test_torch_train_slice import _jax_steps, _port_steps

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STEPS = 3
K = 17
# the heads' pools at 4 x 4: the mask head's output is 8 x 8, the keypoint
# heatmaps 16 x 16
SMALL_HEADS = ("MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", 4,
               "MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION", 4)


def _dense_batch(seed):
    """``_gt_batch(seed)`` with a polygon mask (an irregular heptagon in
    the GT box) and 17 keypoints (around the box, some outside it) for each
    GT slot, the padded one included."""
    b = _gt_batch(seed)
    rng = np.random.RandomState(300 + seed)
    gt = b.gt_boxes.numpy()
    B, G = gt.shape[:2]
    H, W = b.image.shape[1:3]
    masks = np.zeros((B, G, H, W), bool)
    kps = np.zeros((B, G, K, 3), np.float32)
    for i in range(B):
        for g in range(G):
            x1, y1, x2, y2 = gt[i, g]
            ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
            rad = rng.uniform(0.5, 1.0, (7, 1))
            pts = np.stack([(x1 + x2) / 2 + (x2 - x1) / 2 * np.cos(ang),
                            (y1 + y2) / 2 + (y2 - y1) / 2 * np.sin(ang)], -1)
            pts = ((x1 + x2) / 2, (y1 + y2) / 2) + rad * (
                pts - ((x1 + x2) / 2, (y1 + y2) / 2))
            fill_polygon(masks[i, g], pts)
            kps[i, g, :, 0] = rng.uniform(x1 - 3, x2 + 3, K)
            kps[i, g, :, 1] = rng.uniform(y1 - 3, y2 + 3, K)
            kps[i, g, :, 2] = rng.randint(0, 3, K)
    assert masks[:, :2].reshape(B, 2, -1).any(-1).all()
    return b.replace(gt_masks=torch.from_numpy(masks.view(np.uint8)),
                     gt_keypoints=torch.from_numpy(kps))


def _models(*overrides):
    """(jax model, flat flax params, port model, jax cfg, port cfg)."""
    jax_cfg, port_cfg = cfg_pair(*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
                                 "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0,
                                 *SMALL_HEADS, *overrides)
    jm = jax_build_model(jax_cfg)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(_dense_batch(0)),
        train=True)), seed=1)
    pm = drn_wsod_torch.build_model(port_cfg, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    return jm, flat, pm, jax_cfg, port_cfg


FAST = ("MODEL.ROI_HEADS.NAME", "StandardROIHeads", "MODEL.MASK_ON", True,
        "MODEL.KEYPOINT_ON", True)
FAST_LOSSES = {"loss_cls", "loss_box_reg", "loss_mask", "loss_keypoint"}
CASES = {
    "fast_rcnn_freeze_at_2": (FAST + ("MODEL.BACKBONE.FREEZE_AT", 2),
                              FAST_LOSSES),
    "fast_rcnn_freeze_at_5": (FAST, FAST_LOSSES),
    "cascade_freeze_at_2": (("MODEL.ROI_HEADS.NAME", "CascadeROIHeads",
                             "MODEL.MASK_ON", True,
                             "MODEL.BACKBONE.FREEZE_AT", 2,
                             "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG",
                             True),
                            {f"loss_{n}_stage{k}" for n in ("cls", "box_reg")
                             for k in range(3)} | {"loss_mask"}),
}


def test_mask_targets_equal_jax_per_box_crops():
    """The channel crop of ``mask_branch_loss`` against the JAX package's
    per-box RoIAlign of the matched mask: bit-equal, at two output sizes."""
    b = _dense_batch(1)
    rng = np.random.RandomState(5)
    boxes = b.proposals.numpy()[:, :13].copy()
    boxes += rng.uniform(-2, 2, boxes.shape).astype(np.float32)
    masks = b.gt_masks.numpy()
    midx = rng.randint(0, 3, boxes.shape[:2])
    for m in (8, 28):
        for i in range(2):
            maps = torch.from_numpy(masks[i]).permute(1, 2, 0).float()
            got = drn_wsod_torch.ops.roi_align.roi_align(
                maps.contiguous(), torch.from_numpy(boxes[i]), 1.0, m, 2,
                aligned=True).numpy()[np.arange(13), :, :, midx[i]]
            want = np.stack([np.asarray(jax_roi_align(
                masks[i, g][..., None].astype(np.float32), bx[None], 1.0,
                resolution=m, sampling_ratio=2, aligned=True))[0, ..., 0]
                for g, bx in zip(midx[i], boxes[i])])
            np.testing.assert_array_equal(got, want)
            assert 0 < (got >= 0.5).mean() < 1


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectories(request):
    overrides, names = CASES[request.param]
    jm, flat, pm, jax_cfg, port_cfg = _models(*overrides)
    batches = [_dense_batch(s) for s in range(STEPS)]
    before = {n: t.clone() for n, t in pm.state_dict().items()}
    trainable = {n for n, p in pm.named_parameters() if p.requires_grad}
    jax_state, jax_metrics = _jax_steps(jm, flat, jax_cfg, batches)
    port_state, port_metrics = _port_steps(pm, port_cfg, batches)
    return (request.param, names, jax_state, jax_metrics, port_state,
            port_metrics, before, trainable)


def test_losses_match_at_every_step(trajectories):
    _, names, _, jax_metrics, _, port_metrics, _, _ = trajectories
    for step, (want, got) in enumerate(zip(jax_metrics, port_metrics)):
        assert set(got) == set(want) == names | {"total_loss"}
        for k in want:
            assert np.isfinite(got[k]), (k, step)
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} step {step}")
    assert jax_metrics[0]["loss_mask"] > 0.1
    if "loss_keypoint" in names:
        assert jax_metrics[0]["loss_keypoint"] > 1.0


def test_trained_params_match_and_frozen_unchanged(trajectories):
    case, _, jax_state, _, port_state, _, before, trainable = trajectories
    want = drn_wsod_torch.params_from_jax(flatten(jax_state.params["params"]))
    sd = port_state.model.state_dict()
    heads = {n for n in trainable if n.startswith(("mask_head.",
                                                   "keypoint_head."))}
    assert any(n.startswith("mask_head.") for n in heads)
    for n in trainable:
        np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    # every head weight moved (the keypoint predictor's bias takes no
    # gradient: the spatial softmax ignores a shift of a whole heatmap)
    for n in heads:
        if n.endswith(".weight"):
            assert not torch.equal(sd[n], before[n]), n
    for n, t in before.items():
        if n not in trainable:
            assert torch.equal(sd[n], t), n
    assert port_state.step == STEPS


def _keypoint_gaps(pm, batch, boxes):
    """The top-two logit gap of each (B, D, K) heatmap of ``boxes`` (the
    resized frame), from the port's head."""
    with torch.inference_mode():
        feats = pm.features(batch.image)
        B, D = boxes.shape[:2]
        r = pm.keypoint_pooler_resolution
        logits = pm.keypoint_head(pm.pool_raw(feats, boxes, r).reshape(
            B * D, r, r, -1))
        top = logits.reshape(B * D, -1, K).topk(2, dim=1).values
    return (top[:, 0] - top[:, 1]).reshape(B, D, K).numpy()


def test_detect_masks_and_keypoints_match_jax():
    jm, flat, pm, _, _ = _models(*FAST)
    b = _dense_batch(7)
    topk = 10
    want = jax_detect_fn(jm, 1e-5, 0.5, topk, mask_on=True,
                         keypoint_on=True)({"params": unflatten(flat)},
                                           jax_batch(b))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = drn_wsod_torch.make_detect_fn(pm, 1e-5, 0.5, topk, device="cpu",
                                        mask_on=True, keypoint_on=True)(b)
    got = {k: v.numpy() for k, v in got.items()}
    assert got["mask_probs"].shape == (2, topk, 8, 8)
    assert got["keypoints"].shape == (2, topk, K, 3)
    for i in range(2):
        assert_detections_match({k: v[i] for k, v in got.items()},
                                {k: v[i] for k, v in want.items()},
                                RTOL, ATOL, 4)
    # the detections agree slot for slot here (no near-tie of scores)
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["mask_probs"], want["mask_probs"],
                               rtol=RTOL, atol=ATOL)
    kg, kw = got["keypoints"], want["keypoints"]
    np.testing.assert_allclose(kg[..., 2], kw[..., 2], rtol=RTOL, atol=ATOL)
    resized = (b.proposals.new_tensor(want["boxes"])
               / (b.orig_hw.flip(-1).repeat(1, 2)[:, None].float()
                  / b.image_hw.flip(-1).repeat(1, 2)[:, None].float()))
    decided = _keypoint_gaps(pm, b, resized) > 1e-4
    assert decided.mean() > 0.8, decided.mean()
    np.testing.assert_allclose(kg[..., :2][decided], kw[..., :2][decided],
                               rtol=RTOL, atol=ATOL * 64)


@pytest.mark.parametrize("head,mask,keypoint", [
    ("StandardROIHeads", True, True), ("CascadeROIHeads", True, False),
    ("OICRROIHeads", False, False)])
def test_build_model_heads_and_labels(head, mask, keypoint):
    """MASK_ON and KEYPOINT_ON both set: Fast R-CNN builds both heads,
    Cascade the mask head, the WSOD heads neither, as the JAX package
    builds them; the optimizer labels every parameter as JAX does."""
    overrides = ("MODEL.ROI_HEADS.NAME", head, "MODEL.MASK_ON", True,
                 "MODEL.KEYPOINT_ON", True)
    if head == "CascadeROIHeads":
        overrides += ("MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG", True)
    jm, flat, pm, jax_cfg, _ = _models(*overrides)
    tops = {n.split(".")[0] for n in pm.state_dict()}
    assert ("mask_head" in tops, "keypoint_head" in tops) == (mask, keypoint)
    assert ("mask_head" in {k.split(".")[0] for k in flat},
            "keypoint_head" in {k.split(".")[0] for k in flat}) == (
        mask, keypoint)
    if mask:
        assert pm.mask_head.deconv.weight.shape == (256, 256, 2, 2)
        assert pm.mask_head.predictor.weight.shape == (20, 256, 1, 1)
    if keypoint:
        assert pm.keypoint_head.score_lowres.weight.shape == (512, K, 4, 4)
    want = flatten(jax_labels(unflatten(flat), 5))
    got = drn_wsod_torch.solver.build.make_param_labels(
        [n for n, _ in pm.named_parameters()], 5)
    bridged = {drn_wsod_torch.checkpoint.from_jax.port_name(k): v
               for k, v in want.items()}
    # FrozenBN's four vectors are buffers in the port, not parameters
    assert got == {n: bridged[n] for n in got}
    assert {n: l for n, l in got.items() if n.startswith(
        ("mask_head", "keypoint_head"))} == {
        n: l for n, l in bridged.items() if n.startswith(
            ("mask_head", "keypoint_head"))}


def test_detect_masks_need_the_head():
    _, _, pm, _, _ = _models("MODEL.MASK_ON", True)       # OICR: no head
    detect = drn_wsod_torch.make_detect_fn(pm, 1e-5, 0.5, 5, device="cpu",
                                           mask_on=True)
    with pytest.raises(ValueError, match="mask head"):
        detect(_dense_batch(0))
