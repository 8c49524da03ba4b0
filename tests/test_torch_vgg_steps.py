"""The VGG-16 and plain-ResNet configs end to end against the JAX package,
on the CPU, with narrow heads (DAN [64, 64], float32, dropout 0) and the
same weights through ``params_from_jax``:

  * ``oicr_V_16_DC5_1x.yaml`` (VGG-16 at full width, 3 OICR branches, K1's
    plain twin at stride 8 over 512 channels): 3 train steps of
    ``tests/test_torch_train_slice.py``'s batches against the JAX
    package's ``make_train_step``, and its TTA-AVG on one JPEG
    (``tests/test_torch_tta.py``'s views);
  * ``wsddn_R_18_DC5_1x.yaml`` (the plain R18, res5 at stride 16: K1's plain
    twin at spatial scale 1/16): 3 train steps;
  * K1's plain twin at stride 16 against the JAX kernel's XLA twin, exact;
  * Detectron2-named state dicts of the VGG and the narrow plain-R50 models,
    written by the test, loaded by the port's ``load_reference_weights``
    and by the JAX package's: the same forward.

Tolerance: ``tests/test_torch_train_slice.py``'s rtol 1e-4 and atol 1e-5 on
every loss at every step and on the final trainable parameters (times the
largest value for scores and boxes); the pool exact by value."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch import tta as ptta
from drn_wsod_torch.checkpoint.torch_import import load_reference_weights
from drn_wsod_torch.ops import roi_pool as port_pool
from drn_wsod_tpu import tta as jtta
from drn_wsod_tpu.checkpoint import torch_import as jimport
from drn_wsod_tpu.models import build_model as jax_build_model
from drn_wsod_tpu.ops.roi_pool_pallas import _xla_fallback
from test_torch_common import (CONFIGS, assert_detections_match, cfg_pair,
                               d2_state_dict, flatten, jax_batch,
                               param_shapes, random_params, unflatten)
from test_torch_train_slice import _batch, _jax_steps, _port_steps

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
STEPS = 3
VOC = CONFIGS / "PascalVOC-Detection"
NARROW = ("MODEL.ROI_BOX_HEAD.DAN_DIM", [64, 64], "MODEL.DTYPE", "float32",
          "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
          "MODEL.ROI_BOX_HEAD.DROPOUT", 0.0)
NARROW_R50 = ("MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
              "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
              "MODEL.RESNETS.RES2_OUT_CHANNELS", 32)
CASES = {"oicr_V_16": "oicr_V_16_DC5_1x.yaml",
         "wsddn_R_18": "wsddn_R_18_DC5_1x.yaml"}
TTA = ("TEST.AUG.MIN_SIZES", (40, 72), "TEST.AUG.MAX_SIZE", 200,
       "INPUT.BUCKETS", [64, 96])


def _models(yaml, *overrides, seed=1):
    """(JAX model, flat flax params, port model, JAX cfg, port cfg)."""
    jc, pc = cfg_pair(*NARROW, *overrides, yaml=str(yaml))
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(_batch(0)),
        train=False)), seed=seed)
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    return jm, flat, pm, jc, pc


@pytest.fixture(scope="module", params=sorted(CASES))
def trajectories(request):
    jm, flat, pm, jc, pc = _models(VOC / CASES[request.param])
    batches = [_batch(s) for s in range(STEPS)]
    frozen = {n: t.clone() for n, t in pm.state_dict().items()
              if n.startswith("backbone.")}
    jax_state, want = _jax_steps(jm, flat, jc, batches)
    port_state, got = _port_steps(pm, pc, batches)
    return request.param, pm, jax_state, want, port_state, got, frozen


def test_models_are_the_yamls(trajectories):
    case, pm, *_ = trajectories
    if case == "oicr_V_16":
        assert type(pm.backbone).__name__ == "VGG16"
        assert (pm.feature_stride, pm.box_head.fc1.in_features) == \
            (8, 7 * 7 * 512)
        assert len(pm.box_refinery) == 3
    else:
        assert type(pm.backbone).__name__ == "ResNetPlain"
        assert (pm.feature_stride, pm.box_head.fc1.in_features) == \
            (16, 7 * 7 * 512)
        assert pm.head_type == "WSDDN"
    assert pm.use_pallas_pooler and pm.freeze_backbone
    # the tower keeps channels_last memory: the NHWC map K1 reads is a view
    x = pm.preprocess(_batch(0).image).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = pm.backbone(x)[pm.feature_name]
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert out.permute(0, 2, 3, 1).is_contiguous()


def test_losses_match_at_every_step(trajectories):
    case, _, _, want, _, got, _ = trajectories
    names = {"loss_cls", "total_loss"} | (
        {"loss_cls_r0", "loss_cls_r1", "loss_cls_r2"}
        if case == "oicr_V_16" else set())
    for step, (w, g) in enumerate(zip(want, got)):
        assert set(g) == set(w) == names
        for k in w:
            assert np.isfinite(g[k]), (k, step)
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} step {step}")


def test_final_params_match_and_backbone_frozen(trajectories):
    _, _, jax_state, _, port_state, _, frozen = trajectories
    want = drn_wsod_torch.params_from_jax(
        flatten(jax_state.params["params"]))
    sd = port_state.model.state_dict()
    for n, p in port_state.model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(sd[n].numpy(), want[n].numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=n)
    for n, t in frozen.items():
        assert torch.equal(sd[n], t), n


def test_oicr_v16_tta_matches_jax(tmp_path):
    from PIL import Image

    jm, flat, pm, jc, pc = _models(VOC / CASES["oicr_V_16"], *TTA)
    rs = np.random.RandomState(0)
    path = tmp_path / "im.jpg"
    Image.fromarray(rs.randint(0, 256, (45, 61, 3)).astype(np.uint8)).save(
        path, quality=92)
    x1, y1 = rs.uniform(0, 50, 80), rs.uniform(0, 35, 80)
    boxes = np.stack([x1, y1, np.minimum(x1 + rs.uniform(4, 40, 80), 60),
                      np.minimum(y1 + rs.uniform(4, 30, 80), 44)], 1)
    record = {"file_name": str(path),
              "proposal_boxes": boxes.astype(np.float32),
              "proposal_objectness_logits": np.sort(
                  rs.uniform(-1, 1, 80).astype(np.float32))[::-1].copy(),
              "height": 45, "width": 61, "annotations": []}
    want = jtta.GeneralizedRCNNWithTTAAVG(jc, jm, {"params": unflatten(
        flat)})(record)
    got = ptta.GeneralizedRCNNWithTTAAVG(pc, pm, device="cpu")(record)
    for k in ("all_scores", "all_boxes"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=RTOL,
                                   atol=ATOL * np.abs(w).max(), err_msg=k)
    assert_detections_match(got, want, RTOL, ATOL,
                            pc.TEST.DETECTIONS_PER_IMAGE // 2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", ["random", "half_cells", "off_map"])
def test_pool_twin_exact_at_stride_16(case, dtype):
    """The batched plain version with the fused scale at spatial scale 1/16
    (``round_half_even(box / 16)``, bin edges, clamping) equals the JAX
    kernel's XLA twin bit for bit, by value."""
    rs = np.random.RandomState(["random", "half_cells", "off_map"].index(
        case))
    B, H, W, C, P = 2, 13, 11, 32, 40
    if case == "random":
        x1, y1 = rs.uniform(0, W * 16 * 0.7, (B, P)), \
            rs.uniform(0, H * 16 * 0.7, (B, P))
        boxes = np.stack([x1, y1, x1 + rs.uniform(8, 120, (B, P)),
                          y1 + rs.uniform(8, 120, (B, P))], -1)
    elif case == "half_cells":
        boxes = 16.0 * (rs.randint(-2, 15, (B, P, 4)) + 0.5)
    else:
        x1, y1 = rs.uniform(-200, W * 16 + 80, (B, P)), \
            rs.uniform(-200, H * 16 + 80, (B, P))
        boxes = np.stack([x1, y1, x1 + rs.uniform(1, 400, (B, P)),
                          y1 + rs.uniform(1, 400, (B, P))], -1)
    boxes = boxes.astype(np.float32)
    feat = rs.randn(B, H, W, C).astype(np.float32)
    roi_scale = ((rs.uniform(0, 1, (B, P)) + 1.0)
                 * (rs.uniform(0, 1, (B, P)) > 0.2)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(_xla_fallback, static_argnums=(2, 3))(
        jnp.asarray(feat, jdt), jnp.asarray(boxes), 1.0 / 16, 7,
        jnp.asarray(roi_scale))
    got = port_pool.roi_pool_batched(torch.from_numpy(feat).to(tdt),
                                     torch.from_numpy(boxes), 1.0 / 16, 7,
                                     torch.from_numpy(roi_scale))
    want = np.asarray(want).astype(np.float32)
    assert np.array_equal(got.float().numpy(), want)
    assert (want != 0).mean() > 0.1          # not all bins empty


@pytest.mark.parametrize("case", ["oicr_V_16", "wsddn_R_50"])
def test_detectron2_named_import_matches_jax(case, tmp_path):
    """A Detectron2-named checkpoint (``backbone.plain1.0.conv1.weight`` and
    ``.bias`` for VGG; the 7x7 stem's ``backbone.stem.conv1.norm.*`` and
    the strided blocks' shortcuts for the plain R50) loads into both
    packages to the same forward; nothing is unmatched or missing."""
    yaml, extra = ((VOC / "oicr_V_16_DC5_1x.yaml", ()) if case == "oicr_V_16"
                   else (VOC / "wsddn_R_50_DC5_1x.yaml", NARROW_R50))
    jm, flat, pm, jc, pc = _models(yaml, *extra, seed=1)
    fresh = random_params({k: v.shape for k, v in flat.items()}, seed=7)
    sd = d2_state_dict(drn_wsod_torch.params_from_jax(fresh))
    if case == "oicr_V_16":
        assert "backbone.plain5.0.conv3.bias" in sd
    else:
        assert "backbone.res3.0.shortcut.norm.running_var" in sd
        assert "backbone.stem.conv1.weight" in sd
    path = tmp_path / "d2.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": sd}, f)
    unmatched, missing = load_reference_weights(str(path), pm)
    assert unmatched == [] and missing == []
    loaded = jimport.load_reference_weights(str(path),
                                            {"params": unflatten(flat)})
    b = _batch(4)
    want_s, want_b = jax.jit(lambda v, x: jm.apply(
        v, x, method="inference_scores"))(loaded, jax_batch(b))
    got_s, got_b = pm.inference_scores(b)
    want_s = np.asarray(want_s)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=RTOL,
                               atol=ATOL * np.abs(want_s).max())
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    # the loaded weights are the checkpoint's, not the initial ones
    np.testing.assert_array_equal(
        pm.state_dict()["box_head.fc1.weight"].numpy(),
        drn_wsod_torch.params_from_jax(fresh)["box_head.fc1.weight"])
