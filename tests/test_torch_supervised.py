"""The supervised retraining heads against the JAX package, on the CPU:
Fast R-CNN (``StandardROIHeads``) and Cascade R-CNN (``CascadeROIHeads``).

  * the sampler's core on the keys ``jax.random`` drew for the JAX
    function, ties included (invalid slots all hold key -1; the JAX
    ``top_k`` takes them lowest index first, and so does the port's stable
    descending sort, where ``torch.topk`` would not): indices, classes,
    boxes and validity bit-equal, with fewer and with more proposals than
    slots;
  * ``match_and_label`` bit-equal;
  * ``fast_rcnn_losses`` within rtol 1e-6 (float32, per image);
  * 3 train steps of the toy config (R18, DAN [64, 64], float32, dropout 0,
    the same weights through ``params_from_jax``) against the JAX
    ``make_train_step``: Fast R-CNN at ``FREEZE_AT`` 2 (the differentiable
    pool, res3-res5 trained) and 5 (K1's plain twin), and Cascade R-CNN at
    ``FREEZE_AT`` 2. Each image has 1 to 4 foreground proposals of 13
    valid among 16 slots, so all 13 fill the 16 slots (4 foreground, 12
    background) whatever the keys: the two frameworks draw different keys
    and only the slots' order differs, which sums reorder. IoUs stay more
    than 1e-3 from the stage thresholds. Tolerance: rtol 1e-4, atol 1e-5
    on every loss at every step and on the trained parameters, as the
    other trajectories;
  * ``inference_scores`` of both heads within the same tolerance;
  * the builder's choices and refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.models.heads import cascade as port_cascade
from drn_wsod_torch.models.heads import fast_rcnn as port_frcnn
from drn_wsod_torch.structures.boxes import pairwise_iou
from drn_wsod_tpu.models import build_model as jax_build_model
from drn_wsod_tpu.models.heads import cascade as jax_cascade
from drn_wsod_tpu.models.heads import fast_rcnn as jax_frcnn
from test_torch_common import (CONFIGS, TOY, cfg_pair, flatten, jax_batch,
                               param_shapes, random_params, unflatten)
from test_torch_train_slice import _batch as _slice_batch
from test_torch_train_slice import _jax_steps, _port_steps

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STEPS = 3


def _instances(rng, P, G, H=600, W=800):
    """One image's proposals (P, 4), mask, GT boxes (G, 4), classes and
    validity: a third of the proposals jitter around a GT box (many
    foreground), the rest random; the last GT slots padded."""
    gt = np.stack([rng.uniform(0, W * 0.5, G), rng.uniform(0, H * 0.5, G)],
                  -1)
    gt = np.concatenate([gt, gt + rng.uniform(40, 300, (G, 2))], -1)
    props = np.stack([rng.uniform(0, W * 0.7, P), rng.uniform(0, H * 0.7, P)],
                     -1)
    props = np.concatenate([props, props + rng.uniform(8, 250, (P, 2))], -1)
    near = rng.rand(P) < 0.33
    props[near] = gt[rng.randint(G, size=near.sum())] + rng.uniform(
        -20, 20, (near.sum(), 4))
    mask = rng.rand(P) > 0.1
    valid = np.arange(G) < G - 1
    classes = rng.randint(0, 20, G).astype(np.int32)
    return (props.astype(np.float32), mask, gt.astype(np.float32), classes,
            valid)


@pytest.mark.parametrize("P,G,seed", [(300, 4, 0), (700, 5, 1), (1200, 3, 2),
                                      (40, 2, 3)])
def test_sampler_core_bit_equal_on_jax_keys(P, G, seed):
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    got_fields, want_fields = [], []
    per_image = [_instances(rng, P, G) for _ in range(2)]
    keys = jax.random.split(key, 2)
    fg_keys, bg_keys = [], []
    for (props, mask, gt, cls, valid), k in zip(per_image, keys):
        want_fields.append(jax_frcnn.subsample_proposals(
            jnp.asarray(props), jnp.asarray(mask), jnp.asarray(gt),
            jnp.asarray(cls), jnp.asarray(valid), k))
        k1, k2 = jax.random.split(k)
        fg_keys.append(np.asarray(jax.random.uniform(k1, (P,))))
        bg_keys.append(np.asarray(jax.random.uniform(k2, (P,))))
    stack = [torch.from_numpy(np.stack(a)) for a in zip(*per_image)]
    got = port_frcnn.subsample_proposals(
        *stack, torch.from_numpy(np.stack(fg_keys)),
        torch.from_numpy(np.stack(bg_keys)))
    S = min(512, P)
    assert got.indices.shape == (2, S)
    for b, want in enumerate(want_fields):
        for field in ("indices", "gt_class", "gt_box", "valid"):
            np.testing.assert_array_equal(getattr(got, field)[b].numpy(),
                                          np.asarray(getattr(want, field)),
                                          err_msg=field)
    # at most a quarter of the slots foreground; ties were taken
    n_fg = (got.gt_class >= 0).sum(1)
    assert (n_fg <= S // 4).all()
    assert (~got.valid).any() or P > 512


def test_sampler_ties_follow_jax_not_topk():
    """The Motivation's example: keys [-1, .3, -1, -1, .7, -1, -1]."""
    keys = torch.tensor([[-1, .3, -1, -1, .7, -1, -1]])
    want = np.asarray(jax.lax.top_k(jnp.asarray(keys[0].numpy()), 5)[1])
    np.testing.assert_array_equal(want, [4, 1, 0, 2, 3])
    order = torch.sort(keys, dim=1, descending=True, stable=True)[1][0, :5]
    np.testing.assert_array_equal(order.numpy(), want)


@pytest.mark.parametrize("iou", [0.5, 0.6, 0.7])
def test_match_and_label_bit_equal(iou):
    rng = np.random.RandomState(int(iou * 10))
    batch = [_instances(rng, 200, 4) for _ in range(2)]
    want = [jax_cascade.match_and_label(jnp.asarray(p), jnp.asarray(g),
                                        jnp.asarray(c), jnp.asarray(v), iou)
            for p, _, g, c, v in batch]
    p, _, g, c, v = (torch.from_numpy(np.stack(a)) for a in zip(*batch))
    cls, box = port_cascade.match_and_label(p, g, c, v, iou)
    for b, (wc, wb) in enumerate(want):
        np.testing.assert_array_equal(cls[b].numpy(), np.asarray(wc))
        np.testing.assert_array_equal(box[b].numpy(), np.asarray(wb))
    assert (cls >= 0).any() and (cls < 0).any()


@pytest.mark.parametrize("agnostic", [False, True])
def test_fast_rcnn_losses_match(agnostic):
    rng = np.random.RandomState(5)
    props, mask, gt, cls, valid = _instances(rng, 300, 4)
    k = jax.random.PRNGKey(3)
    sampled = jax_frcnn.subsample_proposals(
        jnp.asarray(props), jnp.asarray(mask), jnp.asarray(gt),
        jnp.asarray(cls), jnp.asarray(valid), k)
    S, R = sampled.indices.shape[0], 1 if agnostic else 20
    logits = rng.randn(S, 21).astype(np.float32)
    deltas = rng.randn(S, 4 * R).astype(np.float32) * 0.1
    want = jax_frcnn.fast_rcnn_losses(
        jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(props),
        sampled, 20, (10.0, 10.0, 5.0, 5.0))
    indices, gt_class, gt_box, valid = (torch.from_numpy(np.array(a))[None]
                                        for a in sampled)
    got = port_frcnn.fast_rcnn_losses(
        torch.from_numpy(logits)[None], torch.from_numpy(deltas)[None],
        torch.from_numpy(props)[None],
        port_frcnn.SampledProposals(indices.long(), gt_class.long(), gt_box,
                                    valid), 20, (10.0, 10.0, 5.0, 5.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[0], float(w), rtol=1e-6)
    assert float(want[1]) > 0


# ------------------------------------------------------------ trajectories
G = 3


def _gt_batch(seed):
    """The train slice's batch (two 64x64 images, 16 slots, the last 3
    padded) with instance GT: near copies of proposals 0 and 5, a padded
    third slot. Each image then has 1 to 4 foreground proposals and no IoU
    within 1e-3 of 0.5, 0.6 or 0.7."""
    b = _slice_batch(seed)
    rng = np.random.RandomState(100 + seed)
    props = b.proposals.numpy()
    gt = np.zeros((2, G, 4), np.float32)
    gt[:, 0] = props[:, 0] + rng.uniform(-1.5, 1.5, (2, 4))
    gt[:, 1] = props[:, 5] + rng.uniform(-1.5, 1.5, (2, 4))
    b = b.replace(gt_boxes=torch.from_numpy(gt),
                  gt_classes=torch.from_numpy(rng.randint(0, 20, (2, G))
                                              .astype(np.int32)),
                  gt_valid=torch.tensor([[True, True, False]] * 2))
    iou = pairwise_iou(b.gt_boxes[:, :2], torch.nan_to_num(b.proposals))
    best = torch.where(b.proposal_mask, iou.max(1).values, 0.0)
    n_fg = (best >= 0.5).sum(1)
    assert ((n_fg >= 1) & (n_fg <= 4)).all(), n_fg
    for thr in (0.5, 0.6, 0.7):
        assert ((best - thr).abs() > 1e-3).all()
    return b


def _models(*overrides):
    """(jax model, flat flax params, port model, jax cfg, port cfg) of the
    toy config with ``overrides``, weights drawn under the flax names."""
    jax_cfg, port_cfg = cfg_pair(*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
                                 "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0,
                                 *overrides)
    jm = jax_build_model(jax_cfg)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(_gt_batch(0)),
        train=False)), seed=1)
    pm = drn_wsod_torch.build_model(port_cfg, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    return jm, flat, pm, jax_cfg, port_cfg


CASES = {
    "fast_rcnn_freeze_at_2": (("MODEL.ROI_HEADS.NAME", "StandardROIHeads",
                               "MODEL.BACKBONE.FREEZE_AT", 2),
                              {"loss_cls", "loss_box_reg"}),
    "fast_rcnn_freeze_at_5": (("MODEL.ROI_HEADS.NAME", "StandardROIHeads"),
                              {"loss_cls", "loss_box_reg"}),
    "cascade_freeze_at_2": (("MODEL.ROI_HEADS.NAME", "CascadeROIHeads",
                             "MODEL.BACKBONE.FREEZE_AT", 2,
                             "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG",
                             True),
                            {f"loss_{n}_stage{k}" for n in ("cls", "box_reg")
                             for k in range(3)}),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectories(request):
    overrides, names = CASES[request.param]
    jm, flat, pm, jax_cfg, port_cfg = _models(*overrides)
    batches = [_gt_batch(s) for s in range(STEPS)]
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
    assert any(v > 0 for k, v in jax_metrics[0].items() if "box_reg" in k)


def test_trained_params_match_and_frozen_unchanged(trajectories):
    case, _, jax_state, _, port_state, _, before, trainable = trajectories
    want = drn_wsod_torch.params_from_jax(flatten(jax_state.params["params"]))
    sd = port_state.model.state_dict()
    backbone = {n for n in trainable if n.startswith("backbone.")}
    if case.endswith("freeze_at_2"):
        assert backbone and all(n.startswith(("backbone.res3",
                                              "backbone.res4",
                                              "backbone.res5"))
                                for n in backbone)
    else:
        assert not backbone
    for n in trainable:
        assert sd[n].dtype == torch.float32
        np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    for n, t in before.items():
        if n not in trainable:
            assert torch.equal(sd[n], t), n
    assert port_state.step == STEPS


@pytest.mark.parametrize("head", ["StandardROIHeads", "CascadeROIHeads"])
def test_inference_scores_match(head):
    jm, flat, pm, _, _ = _models("MODEL.ROI_HEADS.NAME", head)
    b = _gt_batch(7)
    want_s, want_b = jax.jit(lambda v, x: jm.apply(
        v, x, method="inference_scores"))({"params": unflatten(flat)},
                                          jax_batch(b))
    got_s, got_b = pm.inference_scores(b)
    assert got_s.shape == (2, 16, 21)
    assert got_b.shape == ((2, 16, 80) if head == "StandardROIHeads"
                           else (2, 16, 4))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=RTOL,
                               atol=ATOL)
    valid = b.proposal_mask.numpy()
    np.testing.assert_allclose(got_b.numpy()[valid], np.asarray(want_b)[valid],
                               rtol=RTOL, atol=ATOL * 64)
    assert (got_s[:, 13:] == 0).all()
    np.testing.assert_allclose(got_s[:, :13].sum(-1).numpy(), 1.0, rtol=1e-5)


def test_detect_takes_the_heads_boxes():
    """``make_detect_fn`` takes Fast R-CNN's per-class boxes and Cascade's
    class-agnostic ones unchanged."""
    for head in ("StandardROIHeads", "CascadeROIHeads"):
        _, _, pm, _, _ = _models("MODEL.ROI_HEADS.NAME", head)
        detect = drn_wsod_torch.make_detect_fn(pm, 0.0, 0.5, 10,
                                               device="cpu")
        out = detect(_gt_batch(7))
        assert out["boxes"].shape == (2, 10, 4)
        assert out["valid"].any() and torch.isfinite(out["boxes"]).all()


@pytest.mark.parametrize("name,head,pallas", [
    ("retrain_fast_rcnn_WSR_50_DC5_1x", "FastRCNN", False),
    ("cascade_rcnn_WSR_50_DC5_1x", "CascadeRCNN", False)])
def test_build_model_builds_the_yamls(name, head, pallas):
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(CONFIGS / "PascalVOC-Detection" / f"{name}.yaml"))
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]"])
    m = drn_wsod_torch.build_model(cfg, device="cpu")
    assert (m.head_type, m.use_pallas_pooler, m.refine_k) == (head, pallas, 0)
    assert m.cascade_ious == (0.5, 0.6, 0.7)
    names = {n.split(".")[0] for n, _ in m.named_parameters()}
    assert names == {"backbone", "box_head", "box_predictor"}
    if head == "CascadeRCNN":
        assert len(m.box_head) == len(m.box_predictor) == 3
        assert m.box_predictor[0].bbox_pred.out_features == 4
        assert m.box_head[0].fc1.out_features == 1024
    else:
        assert m.box_predictor.bbox_pred.out_features == 80
    # at FREEZE_AT 5 Fast R-CNN pools through K1, as OICR does
    cfg.merge_from_list(["MODEL.BACKBONE.FREEZE_AT", "5"])
    m = drn_wsod_torch.build_model(cfg, device="cpu")
    assert m.use_pallas_pooler


def test_sampler_needs_a_generator():
    _, _, pm, _, _ = _models("MODEL.ROI_HEADS.NAME", "StandardROIHeads")
    with pytest.raises(ValueError, match="generator"):
        pm(_gt_batch(0), train=True)
