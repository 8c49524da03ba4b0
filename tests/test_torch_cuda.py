"""CUDA-only tests: the hand-written RoIPool kernels (K1 batched, whose
body reads each RoI cell once; K2 single image in float and int8 modes, on
K1's body; K3 banded) and the narrow-dtype max (K4) against their plain versions on the
card, and the toy detect path, TTA and train
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


def _equal_by_value(got, want):
    """Equal by value (an empty bin may be -0.0 on one side), NaN where the
    plain version gives NaN."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(torch.where(nan, 0, got), torch.where(nan, 0, want))


def _k1_inputs(dev, dtype, case, B=2, C=24, P=128, seed=11):
    """Boxes in exact cells (8 px each, scale 1/8) for K1's walk: RoIs of
    1-6 cells (one cell in many bins); 8-20 cells (adjacent bins share a
    row and a column); tall and wide ones on a 192x192 map; partly and
    wholly off the map; and NaN cells."""
    g = np.random.RandomState(seed)
    H = W = 192 if case == "tall_wide" else 20
    feat = torch.from_numpy(g.randn(B, H, W, C).astype(np.float32))
    if case == "tiny":
        w, h = g.randint(1, 7, (2, B, P))
    elif case == "tall_wide":
        long_, short = g.randint(100, 193, (B, P)), g.randint(1, 11, (B, P))
        tall = g.uniform(0, 1, (B, P)) < 0.5
        w, h = np.where(tall, short, long_), np.where(tall, long_, short)
    else:
        w, h = g.randint(8, 21, (2, B, P))
    x1 = g.randint(0, W - w + 1)
    y1 = g.randint(0, H - h + 1)
    if case == "off_map":
        x1 = g.randint(-25, W + 5, (B, P))
        y1 = g.randint(-25, H + 5, (B, P))
        x1[:, :4], y1[:, :4] = [-40, W + 3, 2, 5], [3, 4, -40, H + 9]
    boxes = 8.0 * np.stack([x1, y1, x1 + w - 1, y1 + h - 1], -1)
    if case == "nan":
        feat[torch.from_numpy(g.uniform(0, 1, (B, H, W)) < 0.02)] = np.nan
        feat[torch.from_numpy(g.uniform(0, 1, feat.shape) < 0.01)] = np.nan
    scale = g.uniform(1, 2, (B, P)) * (g.uniform(0, 1, (B, P)) > 0.2)
    return (feat.to(dtype).to(dev),
            torch.from_numpy(boxes.astype(np.float32)).to(dev),
            torch.from_numpy(scale.astype(np.float32)).to(dev))


@pytest.mark.parametrize("case", ["tiny", "shared_edges", "tall_wide",
                                  "off_map", "nan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_reads_each_cell_once_matches_plain(cuda, dtype, case):
    feat, boxes, scale = _k1_inputs(cuda, dtype, case)
    before = rp.roi_pool_batched.launches
    got = rp.roi_pool_batched(feat, boxes, 0.125, 7, scale)
    torch.cuda.synchronize()
    assert rp.roi_pool_batched.launches == before + 1
    _equal_by_value(got, rp.roi_pool_plain(feat, boxes, 0.125, 7, scale))
    if case == "nan":
        assert got.isnan().any()


@pytest.mark.parametrize("C", [8, 24, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_channel_widths(cuda, dtype, C):
    feat, boxes, scale = _k1_inputs(cuda, dtype, "shared_edges", C=C, P=48)
    got = rp.roi_pool_batched(feat, boxes, 0.125, 7, scale)
    _equal_by_value(got, rp.roi_pool_plain(feat, boxes, 0.125, 7, scale))


def test_kernel_any_roi_order_and_other_resolutions(cuda):
    """B = 3: RoI order, the top-row order and a random permutation per
    image give the plain output; resolutions 3 and 14 (the wider register
    arrays) too."""
    feat, boxes, scale = _k1_inputs(cuda, torch.bfloat16, "off_map", B=3)
    want = rp.roi_pool_plain(feat, boxes, 0.125, 7, scale)
    perm = torch.stack([torch.randperm(128, generator=torch.Generator()
                                       .manual_seed(b)) for b in range(3)])
    roi_order = torch.arange(128).expand(3, 128)
    for order in (roi_order, rp.top_row_order(boxes), perm):
        order = order.to(device=cuda, dtype=torch.int32).contiguous()
        got = rp._launch_batched(feat, boxes, 0.125, 7, scale, order)
        _equal_by_value(got, want)
    for R in (3, 14):
        _equal_by_value(rp.roi_pool_batched(feat, boxes, 0.125, R, scale),
                        rp.roi_pool_plain(feat, boxes, 0.125, R, scale))


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


def _tta_record(H=45, W=61, n=80, seed=0):
    """A u8 image and a record of ``n`` proposals inside it, for the TTA."""
    g = np.random.RandomState(seed)
    image = g.randint(0, 256, (H, W, 3)).astype(np.uint8)
    x1 = g.uniform(0, W - 10, n)
    y1 = g.uniform(0, H - 10, n)
    boxes = np.stack([x1, y1, np.minimum(x1 + g.uniform(4, 40, n), W - 1),
                      np.minimum(y1 + g.uniform(4, 30, n), H - 1)], 1)
    return image, {"proposal_boxes": boxes.astype(np.float32),
                   "proposal_objectness_logits":
                       g.uniform(-1, 1, n).astype(np.float32),
                   "annotations": [{"category_id": 3,
                                    "bbox": [2.0, 3.0, 30.0, 40.0]}]}


def test_toy_tta_on_cuda_matches_cpu(cuda):
    """TTA-AVG (views built on the device, 2 scales x flip in two bucket
    groups) of the toy OICR config with a regressing last branch, on the
    card and on the CPU from the same weights: all_scores and all_boxes
    within rtol 1e-4 (atol 1e-5 times the largest value), one K1 launch
    per group."""
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
                         "MODEL.PIXEL_STD", "[57.4, 57.1, 58.4]",
                         "WSL.REFINE_REG", "[False, False, True]",
                         "TEST.AUG.MIN_SIZES", "(40, 72)",
                         "TEST.AUG.MAX_SIZE", "200",
                         "INPUT.BUCKETS", "[64, 96]",
                         "MODEL.DTYPE", "float32"])
    cpu_model = drn_wsod_torch.build_model(cfg, device="cpu")
    gpu_model = drn_wsod_torch.build_model(cfg, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    image, record = _tta_record()
    want = drn_wsod_torch.GeneralizedRCNNWithTTAAVG(
        cfg, cpu_model, device="cpu").detect_image(image, record)
    tta = drn_wsod_torch.GeneralizedRCNNWithTTAAVG(cfg, gpu_model)
    before = rp.roi_pool_batched.launches
    got = tta.detect_image(image, record)
    assert rp.roi_pool_batched.launches - before == len(
        tta.groups(image.shape[:2])) == 2
    for k in ("all_scores", "all_boxes"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)
    assert got["valid"].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_kernel_matches_plain_at_a_tta_group(cuda, dtype):
    """K1 at a TTA group's shape: B = 4 views of one image (two scales,
    each with its flip) in one bucket, the proposals scaled by each view's
    float32 (sx, sy) and flipped as the device view build does it."""
    from drn_wsod_torch import tta

    image, record = _tta_record(H=375, W=500, n=96, seed=3)
    views = tta.enumerate_views((375, 500), (768, 864), 4000, True)
    bucket = 1216
    boxes = torch.from_numpy(record["proposal_boxes"]).to(cuda)
    raw = torch.from_numpy(np.pad(image, ((0, 137), (0, 12), (0, 0)),
                                  mode="edge")).to(cuda)
    batch, _ = tta._device_view_batch(
        raw, (375, 500), [(nh, nw) for nh, nw, _ in views],
        [f for _, _, f in views], bucket, boxes,
        torch.ones(96, dtype=torch.bool, device=cuda),
        torch.from_numpy(record["proposal_objectness_logits"]).to(cuda),
        torch.zeros(20, device=cuda))
    g = torch.Generator(device=cuda).manual_seed(5)
    feat = torch.randn(4, bucket // 8, bucket // 8, 24, generator=g,
                       device=cuda).to(dtype)
    scale = batch.objectness + 1.0
    before = rp.roi_pool_batched.launches
    got = rp.roi_pool_batched(feat, batch.proposals, 0.125, 7, scale)
    torch.cuda.synchronize()
    assert rp.roi_pool_batched.launches == before + 1
    _equal_by_value(got, rp.roi_pool_plain(feat, batch.proposals, 0.125, 7,
                                           scale))


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


_IMAGE_CASES = [pytest.param(case, q, id=f"{case}-{'int8' if q else 'float'}")
                for case in ("tiny", "shared_edges", "tall_wide", "off_map",
                             "nan")
                for q in (False, True) if not (q and case == "nan")]


def _image_mode(quantize_int8):
    return "roi_pool_image_int8" if quantize_int8 else "roi_pool_image"


@pytest.mark.parametrize("case,quantize_int8", _IMAGE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_image_kernel_reads_each_cell_once_matches_plain(cuda, dtype, case,
                                                         quantize_int8):
    """K2 on K1's walk, each image alone (the first with its roi_scale, the
    second with None) and looped, against the plain version by value: one
    cell in many bins, bins sharing a row and a column, tall and wide RoIs,
    RoIs off the map, NaN cells (float mode: int8 of NaN is outside both
    packages' contract). Int8 mode moves 16 channels, so C = 48."""
    feat, boxes, scale = _k1_inputs(cuda, dtype, case,
                                    C=48 if quantize_int8 else 24)
    name = _image_mode(quantize_int8)
    for b, rs in ((0, scale[0]), (1, None)):
        before = rp.roi_pool_image.launches[name]
        got = rp.roi_pool_image(feat[b], boxes[b], 0.125, 7, rs,
                                quantize_int8)
        torch.cuda.synchronize()
        assert rp.roi_pool_image.launches[name] == before + 1
        _equal_by_value(got, rp.roi_pool_image_plain(
            feat[b], boxes[b], 0.125, 7, rs, quantize_int8))
    before = rp.roi_pool_image.launches[name]
    looped = rp.roi_pool_looped(feat, boxes, 0.125, 7, scale, quantize_int8)
    torch.cuda.synchronize()
    assert rp.roi_pool_image.launches[name] == before + 2
    for b in range(2):
        _equal_by_value(looped[b], rp.roi_pool_image_plain(
            feat[b], boxes[b], 0.125, 7, scale[b], quantize_int8))
    if case == "nan":
        assert looped.isnan().any()


@pytest.mark.parametrize("quantize_int8,C", [(False, 8), (False, 24),
                                             (False, 2048), (True, 16),
                                             (True, 48), (True, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_image_kernel_channel_widths(cuda, dtype, quantize_int8, C):
    feat, boxes, scale = _k1_inputs(cuda, dtype, "shared_edges", C=C, P=48)
    got = rp.roi_pool_image(feat[0], boxes[0], 0.125, 7, scale[0],
                            quantize_int8)
    _equal_by_value(got, rp.roi_pool_image_plain(
        feat[0], boxes[0], 0.125, 7, scale[0], quantize_int8))


@pytest.mark.parametrize("quantize_int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("R", [3, 14])
def test_image_kernel_other_resolutions(cuda, R, quantize_int8):
    """R = 3 and 14 (the wider register arrays), zero scales included."""
    for dtype in (torch.float32, torch.bfloat16):
        feat, boxes, scale = _k1_inputs(cuda, dtype, "off_map", C=48)
        assert (scale == 0).any()
        got = rp.roi_pool_image(feat[0], boxes[0], 0.125, R, scale[0],
                                quantize_int8)
        _equal_by_value(got, rp.roi_pool_image_plain(
            feat[0], boxes[0], 0.125, R, scale[0], quantize_int8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_image_kernel_float_mode_equals_k1_at_one_image(cuda, dtype):
    """Float mode is K1's launch at B = 1: the same values as K1 on one
    image, empty bins and zero scales included."""
    feat, boxes, scale = _k1_inputs(cuda, dtype, "off_map")
    for b in range(2):
        _equal_by_value(
            rp.roi_pool_image(feat[b], boxes[b], 0.125, 7, scale[b]),
            rp.roi_pool_batched(feat[b:b + 1], boxes[b:b + 1], 0.125, 7,
                                scale[b:b + 1])[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_image_kernel_any_order(cuda, dtype):
    """Any order of the RoIs (RoI order, the top-row order the wrapper
    passes, a permutation) gives the plain output in both modes."""
    feat, boxes, scale = _k1_inputs(cuda, dtype, "shared_edges", C=48)
    f, b, s = feat[0], boxes[0], scale[0]
    q, ch_scale = rp.int8_quantize(f)
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(0))
    for order in (torch.arange(128), rp.top_row_order(b[None])[0], perm):
        order = order.to(device=cuda, dtype=torch.int32).contiguous()
        for int8 in (False, True):
            out = torch.full((128, 7, 7, 48), float("nan"), dtype=dtype,
                             device=cuda)
            rp._launch_image(q if int8 else f, b, 0.125, 7, s, order, out,
                             ch_scale if int8 else None)
            _equal_by_value(out, rp.roi_pool_image_plain(f, b, 0.125, 7, s,
                                                         int8))


def test_looped_int8_quantizes_each_image_alone(cuda):
    """Two images whose absmax differ 10x: each keeps its own ch_scale,
    as the JAX package quantizes inside each per-image call."""
    feat, boxes, scale = _k1_inputs(cuda, torch.bfloat16, "shared_edges",
                                    C=48)
    feat[1] *= 10
    before = rp.roi_pool_image.launches["roi_pool_image_int8"]
    got = rp.roi_pool_looped(feat, boxes, 0.125, 7, scale, True)
    torch.cuda.synchronize()
    assert rp.roi_pool_image.launches["roi_pool_image_int8"] == before + 2
    for b in range(2):
        _equal_by_value(got[b], rp.roi_pool_image_plain(
            feat[b], boxes[b], 0.125, 7, scale[b], True))
    assert (rp.int8_quantize(feat[1])[1] > 5 * rp.int8_quantize(feat[0])[1]
            ).all()


@pytest.mark.parametrize("quantize_int8", [False, True], ids=["float", "int8"])
def test_looped_writes_into_one_output(cuda, monkeypatch, quantize_int8):
    """On the card the looped form allocates its (B, P, R, R, C) output once
    and stacks nothing: its peak is the output and one image's
    quantization, not two outputs."""
    feat, boxes, scale = _k1_inputs(cuda, torch.bfloat16, "shared_edges",
                                    B=3, C=2048, P=64)
    rp.roi_pool_looped(feat, boxes, 0.125, 7, scale, quantize_int8)

    def no_stack(*args, **kwargs):
        raise AssertionError("roi_pool_looped stacked its images")

    monkeypatch.setattr(torch, "stack", no_stack)
    torch.cuda.synchronize()
    quant = 0
    if quantize_int8:
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rp.int8_quantize(feat[0])
        quant = torch.cuda.max_memory_allocated() - base
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = rp.roi_pool_looped(feat, boxes, 0.125, 7, scale, quantize_int8)
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= 1.05 * (got.nbytes + quant)
    monkeypatch.undo()
    for b in range(3):
        _equal_by_value(got[b], rp.roi_pool_image_plain(
            feat[b], boxes[b], 0.125, 7, scale[b], quantize_int8))


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
    # a band that fits alone (5 rows of 2905 vectors: 232400 B) but not
    # beside a one-RoI table
    wide = torch.zeros(1, 5, 2905, 8, dtype=torch.bfloat16, device=cuda)
    for R in (7, 16):
        with pytest.raises(ValueError, match="table"):
            rp.roi_pool_banded(wide, boxes[:1], 0.25, R, scale[:1])
    with pytest.raises(ValueError):           # stride band_rows - small_h < 1
        rp.roi_pool_banded(feat, boxes, 0.25, 7, scale, small_h=12,
                           band_rows=12)
    with pytest.raises(TypeError):
        rp.roi_pool_banded(feat, boxes.cpu(), 0.25, 7, scale)


def _band_cells(dev, dtype, case, seed=5):
    """Boxes in exact cells (8 px each, scale 1/8) for the band launch's
    walk, default 24/48 bands: RoIs of 1-6 cells (one cell in several bins
    of both axes); one band's run of 3 RoI chunks and more; RoIs in the
    last bands, whose start is clamped to H - 48; a 30-row map (the band
    is the whole map); R = 16; and NaN cells with RoIs partly off the map
    (empty bins). Returns (features, boxes, roi_scale, R)."""
    g = np.random.RandomState(seed)
    B, H, W, C, P, R = 2, 100, 40, 16, 96, 7
    w, h = g.randint(1, 7, (2, B, P))
    lo_y, lo_x = 0, 0
    if case == "long_run":
        B, P = 1, 3 * rp.RUN_CHUNK + 5
        w, h = g.randint(1, 31, (B, P)), g.randint(1, 21, (B, P))
    elif case == "short_map":
        H = 30
        h = g.randint(1, 25, (B, P))
    elif case == "res16":
        R = 16
        w, h = g.randint(1, 21, (2, B, P))
    elif case == "nan_empty":
        w, h = g.randint(1, 13, (2, B, P))
        lo_y = lo_x = -8
    feat = torch.from_numpy(g.randn(B, H, W, C).astype(np.float32))
    y1 = g.randint(lo_y, H - h + 1)
    x1 = g.randint(lo_x, W - w + 1)
    if case == "long_run":
        y1 = g.randint(0, 24 - h + 1)                 # all in band 0
    elif case == "last_band":
        y1 = g.randint(70, H, (B, P))
    boxes = 8.0 * np.stack([x1, y1, x1 + w - 1, y1 + h - 1], -1)
    if case == "nan_empty":
        feat[torch.from_numpy(g.uniform(0, 1, (B, H, W)) < 0.03)] = np.nan
    scale = g.uniform(1, 2, (B, P)) * (g.uniform(0, 1, (B, P)) > 0.2)
    return (feat.to(dtype).to(dev),
            torch.from_numpy(boxes.astype(np.float32)).to(dev),
            torch.from_numpy(scale.astype(np.float32)).to(dev), R)


@pytest.mark.parametrize("case", ["narrow", "long_run", "last_band",
                                  "short_map", "res16", "nan_empty"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_band_walk_matches_plain_and_k1(cuda, dtype, case):
    """The band launch's walk from the RoI table, bit for bit against the
    banded plain version and against K1, where it turns: bins sharing
    cells, the chunk loop, the clamped last band, a map shorter than a
    band, the wider register arrays, NaN and empty bins."""
    feat, boxes, scale, R = _band_cells(cuda, dtype, case)
    H = feat.shape[1]
    part = rp.band_partition(boxes, 0.125, H, R)
    assert part.short.float().mean().item() > 0.9
    if case == "long_run":
        runs = part.run_start.diff()
        assert runs.max().item() > 2 * rp.band_tile(feat, 48, R).chunk
    if case == "last_band":
        clamped = part.short & (part.band * part.stride > H - 48)
        assert clamped.any() and (part.band_start[clamped] == H - 48).all()
    before = dict(rp.roi_pool_banded.launches)
    got = rp.roi_pool_banded(feat, boxes, 0.125, R, scale)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in
            rp.roi_pool_banded.launches.items()} == {
        "roi_pool_banded": 1, "roi_pool_banded_rest": 1}
    _equal_by_value(got, rp.roi_pool_banded_plain(feat, boxes, 0.125, R,
                                                  scale))
    _equal_by_value(got, rp.roi_pool_batched(feat, boxes, 0.125, R, scale))
    if case == "nan_empty":
        assert got.isnan().any() and (got == 0).any()


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
