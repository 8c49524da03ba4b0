"""CUDA-only tests: the hand-written RoIPool kernels (K1 batched, K2 single
image in float and int8 modes) against their plain versions on the card,
and the toy detect path and train steps on the card against the CPU. They
skip where no CUDA device exists (the kernels have no CPU mode); run them on
a GPU machine with ``python -m pytest tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.ops import roi_pool as rp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _inputs(dev, dtype, B=2, H=13, W=11, C=32, P=96, seed=0):
    g = np.random.RandomState(seed)
    feat = torch.from_numpy(g.randn(B, H, W, C).astype(np.float32))
    x1 = g.uniform(-60, W * 8 + 20, (B, P))
    y1 = g.uniform(-60, H * 8 + 20, (B, P))
    bw = g.uniform(-30, W * 6, (B, P))          # inverted boxes included
    bh = g.uniform(-30, H * 6, (B, P))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    boxes[:, :8] = 8.0 * (g.randint(-2, 14, (B, 8, 4)) + 0.5)   # half cells
    scale = (g.uniform(1, 2, (B, P)) * (g.uniform(0, 1, (B, P)) > 0.2))
    return (feat.to(dtype).to(dev), torch.from_numpy(boxes).to(dev),
            torch.from_numpy(scale.astype(np.float32)).to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_matches_plain(cuda, dtype):
    feat, boxes, scale = _inputs(cuda, dtype)
    before = rp.roi_pool_batched.launches
    got = rp.roi_pool_batched(feat, boxes, 0.125, 7, scale)
    torch.cuda.synchronize()
    assert rp.roi_pool_batched.launches == before + 1
    want = rp.roi_pool_plain(feat, boxes, 0.125, 7, scale)
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() == 0.0


def test_kernel_rejects_what_it_does_not_take(cuda):
    feat, boxes, scale = _inputs(cuda, torch.bfloat16)
    with pytest.raises(TypeError):
        rp.roi_pool_batched(feat.half(), boxes, 0.125, 7, scale)
    with pytest.raises(ValueError):
        rp.roi_pool_batched(feat.transpose(1, 2), boxes, 0.125, 7, scale)
    with pytest.raises(ValueError):
        rp.roi_pool_batched(feat[..., :4].contiguous(), boxes, 0.125, 7, scale)
    with pytest.raises(TypeError):
        rp.roi_pool_batched(feat, boxes.cpu(), 0.125, 7, scale)


def test_toy_detect_on_cuda_matches_cpu(cuda):
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "MODEL.DTYPE", "float32"])
    cpu_model = drn_wsod_torch.build_model(cfg, device="cpu")
    gpu_model = drn_wsod_torch.build_model(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    batch = drn_wsod_torch.synthetic_batch(2, 64, 64, 64, 20, device="cpu")
    want = drn_wsod_torch.make_detect_fn(cpu_model, 1e-5, 0.3, 20,
                                         device="cpu")(batch)
    before = rp.roi_pool_batched.launches
    got = drn_wsod_torch.make_detect_fn(gpu_model, 1e-5, 0.3, 20)(batch)
    torch.cuda.synchronize()
    assert rp.roi_pool_batched.launches == before + 1
    np.testing.assert_allclose(got["all_scores"].cpu().numpy(),
                               want["all_scores"].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("quantize_int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_image_kernel_matches_plain(cuda, dtype, quantize_int8):
    feat, boxes, scale = _inputs(cuda, dtype)
    name = "roi_pool_image_int8" if quantize_int8 else "roi_pool_image"
    for b in range(feat.shape[0]):
        rs = scale[b] if b == 0 else None
        before = dict(rp.roi_pool_image.launches)
        got = rp.roi_pool_image(feat[b], boxes[b], 0.125, 7, rs,
                                quantize_int8)
        torch.cuda.synchronize()
        assert rp.roi_pool_image.launches[name] == before[name] + 1
        want = rp.roi_pool_image_plain(feat[b], boxes[b], 0.125, 7, rs,
                                       quantize_int8)
        assert got.dtype == dtype and got.shape == want.shape
        assert (got.float() - want.float()).abs().max().item() == 0.0
    looped = rp.roi_pool_looped(feat, boxes, 0.125, 7, scale, quantize_int8)
    torch.cuda.synchronize()
    assert rp.roi_pool_image.launches[name] == before[name] + 1 + 2
    for b in range(feat.shape[0]):
        assert torch.equal(looped[b], rp.roi_pool_image_plain(
            feat[b], boxes[b], 0.125, 7, scale[b], quantize_int8))


def test_image_kernel_rejects_what_it_does_not_take(cuda):
    feat, boxes, scale = _inputs(cuda, torch.bfloat16)
    with pytest.raises(TypeError):
        rp.roi_pool_image(feat[0].half(), boxes[0], 0.125, 7, scale[0])
    with pytest.raises(ValueError):
        rp.roi_pool_image(feat[0].transpose(0, 1), boxes[0], 0.125, 7)
    with pytest.raises(ValueError):            # int8 mode moves 16 channels
        rp.roi_pool_image(feat[0, ..., :8].contiguous(), boxes[0], 0.125, 7,
                          quantize_int8=True)
    with pytest.raises(TypeError):
        rp.roi_pool_image(feat[0], boxes[0].cpu(), 0.125, 7)


def test_toy_train_steps_on_cuda_match_cpu(cuda):
    """Three steps of the toy OICR config (one regressing branch, dropout
    off: the two devices draw different masks) on the card and on the CPU
    from the same weights and batches: every loss at every step and the
    final parameters within rtol 1e-4 (float32, summation order)."""
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "MODEL.ROI_BOX_HEAD.DROPOUT", "0.0",
                         "MODEL.PIXEL_STD", "[57.4, 57.1, 58.4]",
                         "WSL.REFINE_REG", "[False, False, True]",
                         "MODEL.DTYPE", "float32"])
    models = {"cpu": drn_wsod_torch.build_model(cfg, device="cpu")}
    models["cuda"] = drn_wsod_torch.build_model(cfg, device=cuda)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    batches = [drn_wsod_torch.synthetic_batch(2, 64, 64, 16, 20, seed=s,
                                              device="cpu") for s in range(3)]
    for b in batches:
        b.proposal_mask[:, -3:] = False
    losses = {}
    for dev, model in models.items():
        tx = drn_wsod_torch.build_optimizer(cfg, model)
        state = drn_wsod_torch.create_train_state(model, tx)
        step = drn_wsod_torch.make_train_step(model, tx)
        before = rp.roi_pool_batched.launches
        losses[dev] = []
        for b in batches:
            state, m = step(state, b.to(model.pixel_mean.device), 0)
            losses[dev].append({k: v.item() for k, v in m.items()})
        assert rp.roi_pool_batched.launches - before == (
            3 if dev == "cuda" else 0)
    for want, got in zip(losses["cpu"], losses["cuda"]):
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    want_sd = models["cpu"].state_dict()
    for k, v in models["cuda"].state_dict().items():
        np.testing.assert_allclose(v.cpu().numpy(), want_sd[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_train_step_never_waits_on_the_card(cuda):
    """A train step issues its work without a host synchronisation: the
    metrics stay on the device (a second step, after the first one's
    one-time set-up, under torch's sync debug mode)."""
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "WSL.REFINE_REG", "[False, False, True]",
                         "SOLVER.CLIP_GRADIENTS.ENABLED", "True",
                         "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm"])
    model = drn_wsod_torch.build_model(cfg, device=cuda)
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    step = drn_wsod_torch.make_train_step(model, tx)
    batch = drn_wsod_torch.synthetic_batch(2, 64, 64, 16, 20, device=cuda)
    step(state, batch, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, metrics = step(state, batch, 0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(v.is_cuda for v in metrics.values())
    assert all(torch.isfinite(v).item() for v in metrics.values())
