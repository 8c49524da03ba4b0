"""SemanticSegmentor and the mIoU path against the JAX package, on the
CPU:

  * flax's ``GroupNorm`` (epsilon 1e-6, the fast variance E[x^2] - E[x]^2)
    against the port's: within 2e-5 of the largest output on a (2, 9, 11,
    128) float32 map of mean 5 and std 3 over 32 groups (the reductions
    sum in another order; ``F.group_norm``, two-pass at epsilon 1e-5, is
    off by about 8e-6 there too);
  * ``SemSegFPNHead`` (R18-FPN 32 toy, 16-wide scale heads) within 1e-5
    of the largest logit in float32, 3e-2 in bfloat16; ``sem_seg_loss``
    within rtol 1e-6; the model's ``loss_sem_seg`` within rtol 1e-5 (the
    target strided, not resized) and 3 train steps against JAX
    ``make_train_step``;
  * ``make_sem_seg_fn``'s argmax equal to JAX's wherever the upsampled
    logits' two largest are more than 1e-4 apart (the upsampling is
    within 1e-6 of ``jax.image.resize``, not bit-equal), at least 99% of
    the pixels;
  * ``SemSegEvaluator`` exact, and ``sem_seg_inference_on_dataset`` (the
    crop, the nearest resize to the record's size, the GT PNG) exact
    against JAX's on the same predicted maps.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import drn_wsod_torch
from drn_wsod_torch.evaluation import (SemSegEvaluator, make_sem_seg_fn,
                                       sem_seg_inference_on_dataset)
from drn_wsod_torch.models.heads.seg import GroupNorm, sem_seg_loss
from drn_wsod_tpu.evaluation import evaluator as jev
from drn_wsod_tpu.evaluation.sem_seg_eval import \
    SemSegEvaluator as JaxSemSegEvaluator
from drn_wsod_tpu.models import build_model as jax_build_model
from drn_wsod_tpu.models.heads.seg import sem_seg_loss as jax_sem_seg_loss
from test_torch_common import (CONFIGS, cfg_pair, flatten, jax_batch,
                               param_shapes, random_params, unflatten)
from test_torch_retinanet import _batch
from test_torch_train_slice import _jax_steps, _port_steps

torch.set_num_threads(1)

SEM_YAML = str(CONFIGS / "Misc" / "semantic_R_50_FPN_1x.yaml")
S = 5
TOY = ("MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
       "MODEL.FPN.OUT_CHANNELS", 32, "MODEL.SEM_SEG_HEAD.NUM_CLASSES", S,
       "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16, "MODEL.PIXEL_STD",
       [57.4, 57.1, 58.4])


def sem_batch(seed: int, size=(64, 64)):
    """``test_torch_retinanet._batch`` with a (2, H, W) label map of S
    classes, some pixels 255."""
    b = _batch(seed, size)
    rs = np.random.RandomState(50 + seed)
    sem = rs.randint(0, S, b.image.shape[:3]).astype(np.int32)
    sem[:, :3] = 255
    return b.replace(sem_seg=torch.from_numpy(sem))


def models(*overrides, yaml=SEM_YAML):
    jc, pc = cfg_pair(*TOY, *overrides, yaml=yaml)
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(sem_batch(0)))), seed=1)
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    return jm, flat, pm, jc, pc


@pytest.fixture(scope="module")
def f32():
    return models("MODEL.DTYPE", "float32")


def test_group_norm_against_flax():
    rs = np.random.RandomState(0)
    x = (5 + 3 * rs.randn(2, 9, 11, 128)).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, 128).astype(np.float32)
    bias = rs.randn(128).astype(np.float32)
    gn = fnn.GroupNorm(num_groups=32, dtype=jnp.float32)
    want = np.asarray(gn.apply({"params": {"scale": scale, "bias": bias}},
                               jnp.asarray(x)))
    m = GroupNorm(32, 128)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_head_and_model_loss(dtype, tol):
    jm, flat, pm, _, _ = models("MODEL.DTYPE", dtype)
    b = sem_batch(1)
    v = {"params": unflatten(flat)}
    want = np.asarray(jm.apply(v, jax_batch(b), method="semantic_logits"))
    got = pm.semantic_logits(b)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    want = jm.apply(v, jax_batch(b))
    got = pm(b, train=True)
    assert set(got) == set(want) == {"loss_sem_seg"}
    np.testing.assert_allclose(got["loss_sem_seg"].item(),
                               float(want["loss_sem_seg"]), rtol=tol)
    assert pm(b.replace(sem_seg=None), train=True) == {}


@pytest.mark.parametrize("ignore", [255, 3])
def test_sem_seg_loss(ignore):
    rs = np.random.RandomState(ignore)
    logits = (rs.randn(2, 7, 9, 6) * 3).astype(np.float32)
    tgt = rs.randint(0, 6, (2, 7, 9)).astype(np.int32)
    tgt[0, :2] = ignore
    got = sem_seg_loss(torch.from_numpy(logits), torch.from_numpy(tgt),
                       ignore).item()
    want = float(jax_sem_seg_loss(jnp.asarray(logits), jnp.asarray(tgt),
                                  ignore))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    allign = np.full_like(tgt, ignore)
    assert sem_seg_loss(torch.from_numpy(logits),
                        torch.from_numpy(allign), ignore).item() == 0.0


def test_train_steps_match_jax(f32):
    jm, flat, _, jc, pc = f32
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
    batches = [sem_batch(10 + s) for s in range(3)]
    jax_state, jax_metrics = _jax_steps(jm, flat, jc, batches)
    port_state, port_metrics = _port_steps(pm, pc, batches)
    for want, got in zip(jax_metrics, port_metrics):
        assert set(got) == set(want) == {"loss_sem_seg", "total_loss"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    want = drn_wsod_torch.params_from_jax(
        {k: np.asarray(v) for k, v in flatten(
            jax_state.params["params"]).items()})
    sd = port_state.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].float().numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    # the GroupNorms trained, as in the JAX package
    assert not np.allclose(sd["sem_seg_head.p3.0.norm.weight"].numpy(),
                           flat["sem_seg_head.scale_head_1_gn0.scale"])


def test_sem_seg_fn_argmax(f32):
    jm, flat, pm, _, _ = f32
    b = sem_batch(2, (96, 64))
    v = {"params": unflatten(flat)}
    want = np.asarray(jev.make_sem_seg_fn(jm)(v, jax_batch(b)))
    got = make_sem_seg_fn(pm, device="cpu")(b)
    assert got.dtype == torch.int32 and got.shape == (2, 96, 64)
    logits = jm.apply(v, jax_batch(b), method="semantic_logits")
    up = np.asarray(jax.image.resize(logits, (2, 96, 64, S), "bilinear"))
    top2 = np.sort(up, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 1e-4
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(got.numpy()[decided], want[decided])


def test_evaluator_exact():
    rs = np.random.RandomState(0)
    names = [f"c{i}" for i in range(6)]
    pe, je = SemSegEvaluator(names), JaxSemSegEvaluator(names)
    for _ in range(3):
        gt = rs.randint(0, 6, (31, 17))
        gt[rs.rand(31, 17) < 0.1] = 255
        gt[gt == 4] = 2                     # a class with no GT pixel
        pred = rs.randint(0, 7, (31, 17))
        pe.process_single(pred, gt)
        je.process_single(pred, gt)
    got, want = pe.evaluate(), je.evaluate()
    assert got.keys() == want.keys() == {"sem_seg"}
    np.testing.assert_equal(got, want)
    np.testing.assert_equal(pe.state_dict(), je.state_dict())


def test_inference_loop_exact(tmp_path):
    """Both loops on the same loader batches and the same predicted maps
    (one per image id): the valid part cut, resized to the record's size
    by the loop's nearest rule, scored against the GT PNG."""
    from drn_wsod_torch import data as pdata
    from drn_wsod_tpu import data as jdata

    rs = np.random.RandomState(1)
    records = []
    for i, (h, w) in enumerate([(50, 70), (64, 33), (45, 45)]):
        gt = rs.randint(0, S, (h, w)).astype(np.uint8)
        gt[:4] = 255
        path = tmp_path / f"gt{i}.png"
        Image.fromarray(gt).save(path)
        records.append({"image": rs.randint(0, 255, (h, w, 3), np.uint8),
                        "height": h, "width": w, "image_id": i,
                        "sem_seg_file_name": str(path), "annotations": []})
    jc, pc = cfg_pair(*TOY, "INPUT.MIN_SIZE_TEST", 40, "INPUT.MAX_SIZE_TEST",
                      64, "INPUT.BUCKETS", [64], yaml=SEM_YAML)
    preds = {i: rs.randint(0, S, (64, 64)).astype(np.int32)
             for i in range(3)}

    def port_sem(batch):
        return torch.from_numpy(np.stack([preds[int(i)]
                                          for i in batch.image_id]))

    def jax_sem(_, batch):
        return jnp.asarray(np.stack([preds[int(i)]
                                     for i in np.asarray(batch.image_id)]))

    names = [f"c{i}" for i in range(S)]
    got = sem_seg_inference_on_dataset(
        port_sem, pdata.EvalLoader(records, pdata.DatasetMapper(pc, False),
                                   batch_size=2, prefetch=0),
        SemSegEvaluator(names), records)
    want = jev.sem_seg_inference_on_dataset(
        jax_sem, None, jdata.EvalLoader(records, jdata.DatasetMapper(jc,
                                                                     False),
                                        batch_size=2, prefetch=0),
        JaxSemSegEvaluator(names), records)
    np.testing.assert_equal(got, want)
    assert 0 < got["sem_seg"]["mIoU"] < 100
