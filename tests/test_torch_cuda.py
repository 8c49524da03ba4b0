"""CUDA-only tests: the hand-written RoIPool kernels (K1 batched, K2 single
image in float and int8 modes, K3 banded) and the narrow-dtype max (K4)
against their plain versions on the card, and the toy detect path and train
steps on the card against the CPU. They skip where no CUDA device exists
(the kernels have no CPU mode); run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.ops import narrow_max as nm
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


def _band_mix(dev, dtype, case, B=2, H=48, W=40, C=16, P=64, seed=3):
    """The banded mixes of tests/test_roi_pool_pallas.py:221-294 at scale
    1/4 with 12-row bands (small_h 6): short boxes all over, tall ones,
    edge-crossers, one off the map and one whole-image box; or all short;
    or all tall."""
    g = np.random.RandomState(seed)
    feat = torch.from_numpy(g.randn(B, H, W, C).astype(np.float32))
    y1 = g.uniform(-8, H * 4 - 8, (B, P))
    hgt = g.uniform(4, 20, (B, P))
    x1 = g.uniform(-8, W * 4 - 8, (B, P))
    wid = g.uniform(4, 140, (B, P))
    if case != "all_short":
        tall = slice(0, P) if case == "all_tall" else slice(P // 2, P - 2)
        y1[:, tall] = g.uniform(-30, H * 2, (B, P))[:, tall]
        hgt[:, tall] = g.uniform(60, H * 4, (B, P))[:, tall]
    boxes = np.stack([x1, y1, x1 + wid, y1 + hgt], -1).astype(np.float32)
    if case == "mixed":
        boxes[:, -2] = [W * 4 + 50, H * 4 + 50, W * 4 + 60, H * 4 + 60]
        boxes[:, -1] = [0, 0, W * 4 - 1, H * 4 - 1]
    scale = (g.uniform(1, 2, (B, P)) * (g.uniform(0, 1, (B, P)) > 0.2))
    return (feat.to(dtype).to(dev), torch.from_numpy(boxes).to(dev),
            torch.from_numpy(scale.astype(np.float32)).to(dev))


@pytest.mark.parametrize("case", ["mixed", "all_short", "all_tall"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_banded_kernel_matches_plain(cuda, dtype, case):
    feat, boxes, scale = _band_mix(cuda, dtype, case)
    before = dict(rp.roi_pool_banded.launches)
    got = rp.roi_pool_banded(feat, boxes, 0.25, 7, scale, small_h=6,
                             band_rows=12)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in
            rp.roi_pool_banded.launches.items()} == {
        "roi_pool_banded": 1, "roi_pool_banded_rest": 1}
    want = rp.roi_pool_banded_plain(feat, boxes, 0.25, 7, scale, small_h=6,
                                    band_rows=12)
    assert got.dtype == dtype and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() == 0.0
    k1 = rp.roi_pool_batched(feat, boxes, 0.25, 7, scale)
    assert (got.float() - k1.float()).abs().max().item() == 0.0
    short = rp.band_partition(boxes, 0.25, feat.shape[1], 7, 6, 12).short
    assert short.any() == (case != "all_tall")
    assert short.all() == (case == "all_short")


def test_banded_kernel_default_bands_and_small_map(cuda):
    """Default 24/48 bands on a map taller than a band and on one shorter
    than a band (the band is then the whole map)."""
    for H in (13, 100):
        feat, boxes, scale = _inputs(cuda, torch.bfloat16, H=H, W=24, C=32,
                                     P=200, seed=H)
        got = rp.roi_pool_batched(feat, boxes, 0.125, 7, scale,
                                  allow_banded=True)
        want = rp.roi_pool_plain(feat, boxes, 0.125, 7, scale)
        assert (got.float() - want.float()).abs().max().item() == 0.0


def test_banded_kernel_rejects_what_it_does_not_take(cuda):
    feat, boxes, scale = _band_mix(cuda, torch.bfloat16, "mixed")
    with pytest.raises(ValueError):           # not whole 16-byte vectors
        rp.roi_pool_banded(feat[..., :4].contiguous(), boxes, 0.25, 7, scale)
    with pytest.raises(ValueError):           # misaligned map
        flat = torch.zeros(feat.numel() + 1, dtype=feat.dtype, device=cuda)
        rp.roi_pool_banded(flat[1:].view(feat.shape), boxes, 0.25, 7, scale)
    with pytest.raises(ValueError):           # a band beyond shared memory
        wide = torch.zeros(1, 48, 400, 8, dtype=torch.bfloat16, device=cuda)
        rp.roi_pool_banded(wide, boxes[:1], 0.25, 7, scale[:1])
    with pytest.raises(ValueError):           # stride band_rows - small_h < 1
        rp.roi_pool_banded(feat, boxes, 0.25, 7, scale, small_h=12,
                           band_rows=12)
    with pytest.raises(TypeError):
        rp.roi_pool_banded(feat, boxes.cpu(), 0.25, 7, scale)


def test_banded_pool_never_waits_on_the_card(cuda):
    """The partition and both launches issue without a host sync."""
    feat, boxes, scale = _band_mix(cuda, torch.bfloat16, "mixed")
    rp.roi_pool_banded(feat, boxes, 0.25, 7, scale)   # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rp.roi_pool_banded(feat, boxes, 0.25, 7, scale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = rp.roi_pool_banded_plain(feat, boxes, 0.25, 7, scale)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", nm.KINDS)
def test_narrow_max_matches_plain_on_random_bits(cuda, kind):
    """Every bit pattern of the dtype can occur (NaNs, infinities, signed
    zeros and subnormals included): bit for bit against the plain version,
    on the probe's (16, 512) shape and on a larger one."""
    g = torch.Generator().manual_seed(7)
    for shape in ((16, 512), (64, 1024)):
        nbytes = shape[1] // 2 if kind == "int4" else \
            shape[1] * torch.empty(0, dtype=nm.DTYPES[kind]).element_size()
        raw = torch.randint(0, 256, (shape[0], nbytes), generator=g,
                            dtype=torch.uint8)
        raw[0, :4] = torch.tensor([0x80, 0x00, 0x7F, 0xFF])
        raw[shape[0] // 2, :4] = torch.tensor([0x00, 0x80, 0xFF, 0x7F])
        x = raw.view(nm.DTYPES[kind]).to(cuda)
        before = nm.narrow_max.launches[kind]
        got = nm.narrow_max(x, kind)
        torch.cuda.synchronize()
        assert nm.narrow_max.launches[kind] == before + 1
        want = nm.narrow_max_plain(x, kind)
        assert torch.equal(got.view(torch.uint8).cpu(),
                           want.view(torch.uint8).cpu())
        assert torch.equal(want.cpu().view(torch.uint8),
                           nm.narrow_max_plain(x.cpu(), kind).view(
                               torch.uint8))
