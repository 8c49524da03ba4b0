"""CUDA-only tests: the hand-written RoIPool kernels (K1 batched, whose
body reads each RoI cell once; K2 single image in float and int8 modes, on
K1's body; K3 banded) and the narrow-dtype max (K4) against their plain versions on the
card, and the toy detect path, TTA and train
steps on the card against the CPU. They skip where no CUDA device exists
(the kernels have no CPU mode); run them on a GPU machine with
``python -m pytest tests/test_torch_cuda.py``."""

from unittest import mock

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


def _train_boxes(S, B, P, seed):
    """VOC-like proposals (log-uniform sides, inside an image of about
    S x 0.75 S) on a bucket of side S, as the train loader pads them."""
    g = np.random.RandomState(seed)
    H, W = int(S * 0.75), S
    w = np.exp(g.uniform(np.log(8), np.log(W), (B, P)))
    h = np.clip(w * np.exp(g.uniform(-1, 1, (B, P))), 8, H)
    x1 = g.uniform(0, 1, (B, P)) * (W - w)
    y1 = g.uniform(0, 1, (B, P)) * (H - h)
    boxes = np.stack([x1, y1, x1 + w - 1, y1 + h - 1], -1).astype(np.float32)
    scale = (g.uniform(0, 2, (B, P)) * (g.uniform(0, 1, (B, P)) > 0.03))
    return boxes, scale.astype(np.float32)


@pytest.mark.parametrize("side", [64, 112, 152, 204, 252])
def test_kernel_matches_plain_at_train_buckets(cuda, side):
    """K1 at the flagship train step's shapes: B = 4 images of one size
    bucket (512-2016, maps of side/8 = 64-252), 2048-channel bf16 maps,
    P = 4096 proposals with invalid slots."""
    B, P, C = 4, 4096, 2048
    boxes, scale = _train_boxes(side * 8, B, P, seed=side)
    g = torch.Generator(device=cuda).manual_seed(side)
    feat = torch.randn(B, side, side, C, generator=g, device=cuda,
                       dtype=torch.bfloat16)
    boxes = torch.from_numpy(boxes).to(cuda)
    scale = torch.from_numpy(scale).to(cuda)
    before = rp.roi_pool_batched.launches
    got = rp.roi_pool_batched(feat, boxes, 0.125, 7, scale)
    torch.cuda.synchronize()
    assert rp.roi_pool_batched.launches == before + 1
    _equal_by_value(got, rp.roi_pool_plain(feat, boxes, 0.125, 7, scale))


def _toy_trainer(cfg, cuda, batches, prefetch, k):
    from drn_wsod_torch.engine import Trainer, make_multi_train_step

    torch.manual_seed(0)
    model = drn_wsod_torch.build_model(cfg, device=cuda)
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    step = drn_wsod_torch.make_train_step(model, tx)
    seen = []

    def recording(state, batch, seed):
        seen.append({k: (v.device.type, v.dtype) for k, v in
                     batch.tensors().items()})
        return step(state, batch, seed)

    trainer = Trainer(recording, state, iter(batches), 0, log_period=1,
                      multi_step_fn=make_multi_train_step(recording),
                      steps_per_dispatch=k, prefetch_chunks=prefetch,
                      device=cuda)
    trainer.train(0, len(batches))
    losses = trainer.storage.history("total_loss").values()
    return trainer.state, losses, seen


@pytest.mark.parametrize("k", [1, 2], ids=["eager", "chunked"])
def test_trainer_side_stream_prefetch_matches_synchronous(cuda, monkeypatch,
                                                          k):
    """Two toy train steps fed through the pinned side-stream prefetch
    (host batches, u8 images, of two size buckets) equal the same steps
    fed synchronously: losses, parameters and momentum within rtol 1e-5
    (the backward's atomic sums may order differently from run to run; a
    batch read before its copy arrived would differ grossly)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "MODEL.ROI_BOX_HEAD.DROPOUT", "0.0",
                         "MODEL.PIXEL_STD", "[57.4, 57.1, 58.4]",
                         "MODEL.DTYPE", "float32"])
    batches = []
    for s, size in enumerate((64, 96)):
        b = drn_wsod_torch.synthetic_batch(2, size, size, 16, 20, seed=s,
                                           device="cpu")
        batches.append(b.replace(image=b.image.to(torch.uint8)))
    runs = [_toy_trainer(cfg, cuda, batches, prefetch, kk)
            for prefetch, kk in ((0, 1), (2, k))]
    (sync_state, sync_losses, _), (state, losses, seen) = runs
    assert all(d == "cuda" for s in seen for d, _ in s.values())
    assert seen[0]["image"][1] == torch.uint8
    assert [it for _, it in losses] == [it for _, it in sync_losses] == [0, 1]
    np.testing.assert_allclose([v for v, _ in losses],
                               [v for v, _ in sync_losses], rtol=1e-5)
    assert state.step == sync_state.step == 2
    want = sync_state.model.state_dict()
    for name, t in state.model.state_dict().items():
        torch.testing.assert_close(t, want[name], rtol=1e-5, atol=1e-6)
    for name, t in state.opt_state["trace"].items():
        torch.testing.assert_close(t, sync_state.opt_state["trace"][name],
                                   rtol=1e-5, atol=1e-6)


def test_default_predictor_on_cuda_matches_cpu(cuda):
    """The toy config's DefaultPredictor on the card against the CPU from
    the same weights: one K1 launch a call, detections within rtol 1e-4."""
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
                         "MODEL.PIXEL_STD", "[57.4, 57.1, 58.4]",
                         "INPUT.MIN_SIZE_TEST", "64",
                         "INPUT.MAX_SIZE_TEST", "96",
                         "TEST.DETECTIONS_PER_IMAGE", "5",
                         "MODEL.DTYPE", "float32"])
    cpu = drn_wsod_torch.DefaultPredictor(cfg, device="cpu")
    model = drn_wsod_torch.build_model(cfg, device=cuda)
    model.load_state_dict(cpu.model.state_dict())
    card = drn_wsod_torch.DefaultPredictor(cfg, model=model, device=cuda)
    image, record = _tta_record(H=45, W=61, n=60, seed=4)
    before = rp.roi_pool_batched.launches
    got = card(image, record["proposal_boxes"],
               record["proposal_objectness_logits"])
    assert rp.roi_pool_batched.launches == before + 1
    want = cpu(image, record["proposal_boxes"],
               record["proposal_objectness_logits"])
    s = want["scores"]
    np.testing.assert_allclose(got["scores"], s, rtol=1e-4, atol=1e-6)
    # classes and boxes where a score stands apart from its neighbours
    gap = np.abs(np.diff(s)) > 1e-4 * np.abs(s).max()
    lone = np.ones(len(s), bool)
    lone[1:] &= gap
    lone[:-1] &= gap
    np.testing.assert_array_equal(got["classes"][lone], want["classes"][lone])
    np.testing.assert_allclose(got["boxes"][lone], want["boxes"][lone],
                               rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# PCL, CSC and the differentiable pool (no hand-written kernel: plain torch
# ops on the card against the same ops on the CPU)
# ---------------------------------------------------------------------------

def _same_clusters(a, b) -> bool:
    """The same centers and valid mask, and center scores (each the
    highest score among a center's graph neighbours) within float noise:
    a center can stay while its neighbours change."""
    return (torch.equal(a.centers, b.centers)
            and torch.equal(a.center_valid, b.center_valid)
            and torch.allclose(a.center_scores, b.center_scores, rtol=1e-5,
                               atol=0.0))


def _toy_cfg(*extra):
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "MODEL.ROI_BOX_HEAD.DROPOUT", "0.0",
                         "MODEL.PIXEL_STD", "[57.4, 57.1, 58.4]",
                         "MODEL.DTYPE", "float32", *extra])
    return cfg


def _head_batches(n=3):
    batches = [drn_wsod_torch.synthetic_batch(2, 64, 64, 16, 20, seed=s,
                                              device="cpu") for s in range(n)]
    for b in batches:
        b.proposal_mask[:, -3:] = False
        # near-whole-image boxes: positive CSC contrasts beside negative ones
        b.proposals[:, :2] = torch.tensor([[2.0, 3.0, 60.0, 61.0],
                                           [0.0, 0.0, 63.0, 50.0]])
    return batches


def _steps_on_both(cfg, make_step, card, mined=None):
    """The same 3 steps on the CPU and on ``card`` from the same weights:
    ({"cpu" / "cuda": per-step metrics}, {...: model}, K1 launches on the
    card). ``mined`` ({"cpu": [], "cuda": []}) collects each device's PCL
    mining inputs."""
    from drn_wsod_torch.ops import pcl as pcl_lib

    models = {"cpu": drn_wsod_torch.build_model(cfg, device="cpu")}
    models["cuda"] = drn_wsod_torch.build_model(cfg, device=card)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    metrics, k1 = {}, 0
    branch_loss = pcl_lib.pcl_branch_loss
    for dev, model in models.items():
        def recording(cls_logits, prev, proposals, mask, labels, **k):
            if mined is not None:
                mined[dev].append((prev.clone(), proposals, mask, labels))
            return branch_loss(cls_logits, prev, proposals, mask, labels, **k)

        pcl_lib.pcl_branch_loss = recording
        try:
            tx = drn_wsod_torch.build_optimizer(cfg, model)
            state = drn_wsod_torch.create_train_state(model, tx)
            step = make_step(model, tx)
            before = rp.roi_pool_batched.launches
            metrics[dev] = []
            for b in _head_batches():
                state, m = step(state, b.to(model.pixel_mean.device), 0)
                metrics[dev].append({k: v.item() for k, v in m.items()})
            if dev == "cuda":
                k1 = rp.roi_pool_batched.launches - before
        finally:
            pcl_lib.pcl_branch_loss = branch_loss
    return metrics, models, k1


def test_toy_pcl_steps_on_cuda_match_cpu(cuda):
    """Three steps of the toy PCL config on the card and on the CPU: one
    K1 launch a step; the card mines its own inputs exactly as the CPU
    mines them. The two devices' softmax and sums differ in the last bits,
    and at a near-tie that moves the clusters (centers, or center scores
    beyond float noise). Every loss is compared within rtol 1e-4 up to the
    first step where a branch's two inputs give different clusters, and at
    that step every loss but those branches'."""
    from drn_wsod_torch.ops.pcl import mine_pcl_clusters

    cfg = _toy_cfg("MODEL.ROI_HEADS.NAME", "PCLROIHeads")
    mined = {"cpu": [], "cuda": []}
    metrics, _, k1 = _steps_on_both(cfg, drn_wsod_torch.make_train_step,
                                    cuda, mined)
    assert k1 == 3 and len(mined["cpu"]) == len(mined["cuda"]) == 9
    parted = []
    for on_cpu, on_card in zip(mined["cpu"], mined["cuda"]):
        card_inputs_on_cpu = mine_pcl_clusters(*(t.cpu() for t in on_card))
        for got, want in zip(mine_pcl_clusters(*on_card),
                             card_inputs_on_cpu):
            assert torch.equal(got.cpu(), want)
        parted.append(not _same_clusters(mine_pcl_clusters(*on_cpu),
                                         card_inputs_on_cpu))
    _compare_until_parted(metrics["cpu"], metrics["cuda"], parted)


def _compare_until_parted(want_steps, got_steps, parted, branches=3):
    """Every loss of every step before the first step with a parted branch
    (``parted``: one flag per mining call, step-major), and at that step
    every loss but the parted branches' and the total."""
    first = next((i // branches for i, p in enumerate(parted) if p),
                 len(want_steps))
    for s, (want, got) in enumerate(zip(want_steps, got_steps)):
        if s > first:
            break
        skip = ({"total_loss"} | {f"loss_cls_r{k}" for k in range(branches)
                                  if parted[s * branches + k]}
                if s == first else set())
        assert want.keys() == got.keys()
        for k in want.keys() - skip:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{k} step {s}")


@pytest.mark.parametrize("freeze_at", [2, 5])
def test_toy_csc_steps_on_cuda_match_cpu(cuda, freeze_at):
    """Three CSC steps (tau 0) on the card and on the CPU: no K1 launch
    (CSC pools through the differentiable pool), every loss and ``csc/*``
    metric and the final parameters within rtol 1e-4; live maps at
    FREEZE_AT 2 (W != 1), zero maps at 5 (W = 1: 13 of 16 slots valid)."""
    from drn_wsod_torch.engine import make_csc_train_step

    cfg = _toy_cfg("MODEL.ROI_HEADS.NAME", "CSCROIHeads",
                   "MODEL.BACKBONE.FREEZE_AT", str(freeze_at))
    metrics, models, k1 = _steps_on_both(
        cfg, lambda m, tx: make_csc_train_step(m, tx, tau=0.0), cuda)
    assert k1 == 0
    for want, got in zip(metrics["cpu"], metrics["cuda"]):
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        assert (got["csc/W_pos_mean"] == 13 / 16) == (freeze_at == 5)
    want_sd = models["cpu"].state_dict()
    for k, v in models["cuda"].state_dict().items():
        np.testing.assert_allclose(v.cpu().numpy(), want_sd[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_pcl_mining_on_cuda_equals_cpu(cuda):
    """``mine_pcl_clusters`` at P = 512, C = 20 on the card and on the CPU,
    bit for bit: the prefix sums are elementwise adds in a fixed order on
    both devices, and every other step is a sort, a select or IEEE
    arithmetic."""
    from drn_wsod_torch.ops.pcl import mine_pcl_clusters

    rs = np.random.RandomState(9)
    B, P, C = 2, 512, 20
    x1, y1 = rs.uniform(0, 300, (2, B, P))
    boxes = np.stack([x1, y1, x1 + rs.uniform(4, 200, (B, P)),
                      y1 + rs.uniform(4, 200, (B, P))], -1).astype(np.float32)
    scores = np.clip(rs.dirichlet(np.full(P, 0.2), (B, C)).transpose(0, 2, 1)
                     * 4, 0, 1).astype(np.float32)
    mask = rs.uniform(size=(B, P)) > 0.1
    labels = (rs.uniform(size=(B, C)) < 0.4).astype(np.float32)
    args = [torch.from_numpy(a) for a in (scores, boxes, mask, labels)]
    want = mine_pcl_clusters(*args)
    got = mine_pcl_clusters(*(a.to(cuda) for a in args))
    assert want.center_valid.any()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_differentiable_pool_on_cuda_matches_cpu(cuda):
    """The differentiable pool's forward bit-equal on the card and the CPU
    (gathers and maxima), its map gradient within 1e-6 of the largest
    (the scatter-adds sum in another order)."""
    from drn_wsod_torch.ops.roi_align import roi_pool

    rs = np.random.RandomState(4)
    feat = torch.from_numpy(rs.randn(24, 20, 16).astype(np.float32))
    x1, y1 = rs.uniform(-16, 180, (2, 600))
    boxes = torch.from_numpy(np.stack(
        [x1, y1, x1 + rs.uniform(1, 120, 600), y1 + rs.uniform(1, 120, 600)],
        -1).astype(np.float32))
    ct = torch.from_numpy(rs.randn(600, 7, 7, 16).astype(np.float32))
    grads = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda)):
        f = feat.to(dev).detach().requires_grad_(True)
        out = roi_pool(f, boxes.to(dev), 0.125, 7)
        (out * ct.to(dev)).sum().backward()
        grads[name] = (out.detach().cpu(), f.grad.cpu())
    assert torch.equal(grads["card"][0], grads["cpu"][0])
    g = grads["cpu"][1]
    torch.testing.assert_close(grads["card"][1], g, rtol=0,
                               atol=1e-6 * g.abs().max().item())


@pytest.mark.parametrize("C,stride,side", [(512, 8, 152), (2048, 16, 76)],
                         ids=["vgg_512_stride8", "plain_r50_2048_stride16"])
def test_kernel_matches_plain_at_vgg_and_plain_resnet_maps(cuda, C, stride,
                                                           side):
    """K1 at the train step's shapes of the other backbones: B = 4 images
    of the 1216 bucket, VGG-16's 512-channel stride-8 plain5 (152^2) and
    the plain R50's 2048-channel stride-16 res5 (76^2), bf16, P = 4096:
    spatial scale 1/16 rounds box / 16 half to even."""
    B, P = 4, 4096
    boxes, scale = _train_boxes(side * stride, B, P, seed=side)
    g = torch.Generator(device=cuda).manual_seed(C)
    feat = torch.randn(B, side, side, C, generator=g, device=cuda,
                       dtype=torch.bfloat16)
    boxes = torch.from_numpy(boxes).to(cuda)
    scale = torch.from_numpy(scale).to(cuda)
    before = rp.roi_pool_batched.launches
    got = rp.roi_pool_batched(feat, boxes, 1.0 / stride, 7, scale)
    torch.cuda.synchronize()
    assert rp.roi_pool_batched.launches == before + 1
    _equal_by_value(got, rp.roi_pool_plain(feat, boxes, 1.0 / stride, 7,
                                           scale))


@pytest.mark.parametrize("overrides", [
    ("MODEL.BACKBONE.NAME", "build_vgg_backbone",
     "MODEL.ROI_HEADS.IN_FEATURES", "['plain5']"),
    ("MODEL.BACKBONE.NAME", "build_resnet_backbone",
     "MODEL.ROI_HEADS.NAME", "WSDDNROIHeads")],
    ids=["vgg16_oicr", "plain_r18_wsddn"])
def test_toy_vgg_and_plain_resnet_steps_on_cuda_match_cpu(cuda, overrides):
    """Three steps of a toy VGG-16 OICR and a toy plain-R18 WSDDN config on
    the card and on the CPU from the same weights: one K1 launch a step
    (stride 8 and stride 16), the tower's output in channels_last memory,
    every loss and the final parameters within rtol 1e-4."""
    cfg = _toy_cfg(*overrides)
    metrics, models, k1 = _steps_on_both(cfg, drn_wsod_torch.make_train_step,
                                         cuda)
    assert k1 == 3
    card_model = models["cuda"]
    assert card_model.feature_stride == (8 if "vgg" in overrides[1] else 16)
    # cuDNN keeps channels_last: the NHWC map K1 reads is a view
    x = card_model.preprocess(_head_batches(1)[0].image.to(cuda))
    with torch.no_grad():
        out = card_model.backbone(x.permute(0, 3, 1, 2))
    assert out[card_model.feature_name].is_contiguous(
        memory_format=torch.channels_last)
    for want, got in zip(metrics["cpu"], metrics["cuda"]):
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    want_sd = models["cpu"].state_dict()
    for k, v in models["cuda"].state_dict().items():
        np.testing.assert_allclose(v.cpu().numpy(), want_sd[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("freeze_at", [2, 5])
def test_toy_wsjds_steps_on_cuda_match_cpu(cuda, freeze_at):
    """Three WSJDS steps (the CSC step, tau 0, with the seg branch and the
    CRF constraint) on the card and on the CPU: no K1 launch, every loss
    and metric within rtol 1e-4 but ``loss_constraint`` within rtol 1e-3
    (ten CRF iterations amplify rounding near label ties); then
    ``semantic_logits``' refined probabilities within atol 1e-4."""
    from drn_wsod_torch.engine import make_csc_train_step

    cfg = _toy_cfg("MODEL.ROI_HEADS.NAME", "WSJDSROIHeads",
                   "MODEL.SEM_SEG_HEAD.CONSTRAINT", "True",
                   "MODEL.BACKBONE.FREEZE_AT", str(freeze_at))
    metrics, models, k1 = _steps_on_both(
        cfg, lambda m, tx: make_csc_train_step(m, tx, tau=0.0), cuda)
    assert k1 == 0
    for want, got in zip(metrics["cpu"], metrics["cuda"]):
        assert {"loss_seg", "loss_constraint"} <= want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(
                got[k], want[k], rtol=1e-3 if k == "loss_constraint"
                else 1e-4, atol=1e-6, err_msg=k)
    b = _head_batches(1)[0]
    want = models["cpu"].semantic_logits(b).exp()
    got = models["cuda"].semantic_logits(b.to(cuda)).exp().cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_crf_forward_on_cuda_matches_cpu(cuda):
    """``crf_forward`` at a 76x100 map of 21 labels, B = 2, on the card and
    on the CPU: the refined probabilities within atol 1e-4 (ten
    iterations amplify the two devices' rounding near label ties)."""
    from drn_wsod_torch.ops.crf import crf_forward

    rs = np.random.RandomState(12)
    probs = torch.from_numpy(rs.dirichlet(np.full(21, 0.3), (2, 76, 100))
                             .astype(np.float32))
    image = torch.from_numpy(rs.randint(0, 256, (2, 76, 100, 3))
                             .astype(np.uint8))
    want = crf_forward(probs, image)
    got = crf_forward(probs.to(cuda), image.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# COCO data and trainable BatchNorm: K1's float32 mode at full width, and
# a toy NORM BN detector evaluated by the COCO box evaluator on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side", [64, 191])
def test_kernel_float32_mode_at_full_width(cuda, side):
    """K1 in its float32 mode (a NORM BN backbone's map) at the flagship
    train step's shapes: B = 4, 2048 channels at stride 8, up to the 1528
    bucket's 191^2 map, P = 4096 with invalid slots; the output (4, 4096,
    7, 7, 2048) float32 is 6.6 GB."""
    B, P, C = 4, 4096, 2048
    boxes, scale = _train_boxes(side * 8, B, P, seed=side + 1)
    g = torch.Generator(device=cuda).manual_seed(side)
    feat = torch.randn(B, side, side, C, generator=g, device=cuda)
    boxes = torch.from_numpy(boxes).to(cuda)
    scale = torch.from_numpy(scale).to(cuda)
    before = rp.roi_pool_batched.launches
    got = rp.roi_pool_batched(feat, boxes, 0.125, 7, scale)
    torch.cuda.synchronize()
    assert rp.roi_pool_batched.launches == before + 1
    assert got.dtype == torch.float32
    want = rp.roi_pool_plain(feat, boxes, 0.125, 7, scale)
    _equal_by_value(got, want)
    del got, want
    torch.cuda.empty_cache()


def _coco_records(n, seed):
    """``n`` COCO-style records with decoded pixels (as a packed shard
    holds them): 80 contiguous classes, crowd boxes marked difficult, the
    last image without annotations, 60 proposals each."""
    g = np.random.RandomState(seed)
    records = []
    for i in range(n):
        H, W = int(g.randint(40, 70)), int(g.randint(40, 70))
        annos = []
        for k in range(0 if i == n - 1 else g.randint(1, 4)):
            x, y = g.uniform(0, W / 2), g.uniform(0, H / 2)
            crowd = int(k == 0 and i == 0)
            annos.append({"category_id": int(g.randint(80)),
                          "bbox": [x, y, x + g.uniform(8, W / 2),
                                   y + g.uniform(8, H / 2)],
                          "bbox_mode": "XYXY_ABS", "difficult": crowd,
                          "iscrowd": crowd})
        x1, y1 = g.uniform(0, W - 10, 60), g.uniform(0, H - 10, 60)
        boxes = np.stack([x1, y1, np.minimum(x1 + g.uniform(6, W, 60), W - 1),
                          np.minimum(y1 + g.uniform(6, H, 60), H - 1)], 1)
        records.append({
            "file_name": f"coco_toy/{i}.jpg", "image_id": 500 + i,
            "height": H, "width": W, "annotations": annos,
            "image": g.randint(0, 256, (H, W, 3)).astype(np.uint8),
            "proposal_boxes": boxes.astype(np.float32),
            "proposal_objectness_logits": g.uniform(-2, 2, 60).astype(
                np.float32),
            "proposal_bbox_mode": "XYXY_ABS"})
    return records


def test_toy_bn_coco_eval_on_cuda_matches_cpu(cuda, monkeypatch):
    """A toy NORM BN detector (80 classes) through ``train_net.do_test``
    (the test loader, one image a batch) into the COCO box evaluator, on
    the card and on the CPU from the same weights: one K1 launch an image,
    each on a float32 map; per-image scores within rtol 1e-4; the COCO
    metrics finite in [0, 100] or NaN alike, and within 0.5 points."""
    from drn_wsod_torch.data import DatasetCatalog, MetadataCatalog
    from drn_wsod_torch.evaluation import coco_eval
    from drn_wsod_torch.models import meta_arch
    from drn_wsod_torch.tools import train_net

    name = "torch_cuda_coco_toy"
    records = _coco_records(4, seed=9)
    DatasetCatalog.register(name, lambda: [dict(r) for r in records])
    MetadataCatalog.get(name).set(thing_classes=[f"c{i}" for i in range(80)],
                                  evaluator_type="coco")
    cfg = _toy_cfg("MODEL.RESNETS.NORM", "BN",
                   "MODEL.ROI_HEADS.NUM_CLASSES", "80",
                   "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
                   "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
                   "TEST.AUG.ENABLED", "False",
                   "TEST.DETECTIONS_PER_IMAGE", "10",
                   "DATASETS.TEST", f"('{name}',)",
                   "DATASETS.PROPOSAL_FILES_TEST", "()")
    dets, maps = {}, []
    pool = meta_arch.roi_pool_batched

    def capture(feats, *a):
        maps.append((feats.device.type, feats.dtype))
        return pool(feats, *a)
    monkeypatch.setattr(meta_arch, "roi_pool_batched", capture)
    process = coco_eval.COCODetectionEvaluator.process_single
    try:
        models = {"cpu": drn_wsod_torch.build_model(cfg, device="cpu")}
        for bn in (m for m in models["cpu"].modules()
                   if type(m).__name__ == "BatchNorm"):
            g = torch.Generator().manual_seed(bn.running_var.numel())
            bn.running_mean.normal_(0.0, 0.1, generator=g)
            bn.running_var.uniform_(0.5, 1.5, generator=g)
        models["cuda"] = drn_wsod_torch.build_model(cfg, device=cuda)
        models["cuda"].load_state_dict(models["cpu"].state_dict())
        results = {}
        for dev, model in models.items():
            def recording(self, image_id, boxes, scores, classes, valid,
                          _d=dev):
                dets.setdefault(_d, {})[image_id] = np.asarray(scores)
                return process(self, image_id, boxes, scores, classes, valid)
            monkeypatch.setattr(coco_eval.COCODetectionEvaluator,
                                "process_single", recording)
            before = rp.roi_pool_batched.launches
            results[dev] = train_net.do_test(
                cfg, model, device=model.pixel_mean.device)[name]
            if dev == "cuda":
                assert rp.roi_pool_batched.launches - before == 4
    finally:
        DatasetCatalog.remove(name)
    assert maps.count(("cuda", torch.float32)) == 4
    assert dets["cuda"].keys() == dets["cpu"].keys() and len(dets["cpu"]) == 4
    for image_id, s in dets["cpu"].items():
        np.testing.assert_allclose(dets["cuda"][image_id], s, rtol=1e-4,
                                   atol=1e-6)
    got, want = results["cuda"]["bbox"], results["cpu"]["bbox"]
    assert got.keys() == want.keys() == {"AP", "AP50", "AP75", "APs", "APm",
                                         "APl"}
    for k, w in want.items():
        g = got[k]
        assert np.isnan(g) == np.isnan(w), k
        if not np.isnan(w):
            assert 0 <= g <= 100 and abs(g - w) <= 0.5, (k, g, w)


def _pyramid_boxes(rs, P, side):
    """Boxes over a side x side image: past every border, tiny and whole."""
    x1, y1 = rs.uniform(-0.3 * side, side, (2, P))
    bw, bh = np.exp(rs.uniform(np.log(0.5), np.log(1.2 * side), (2, P)))
    b = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    b[:2] = [[0, 0, side, side], [3, 3, 3, 3]]
    return torch.from_numpy(b)


def _within_bf16_ulp(got, want):
    """``got`` (on the card) within one bfloat16 ulp of each CPU value."""
    want = want.float()
    ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp(
        min=2.0 ** -126))) - 7)
    assert ((got.float().cpu() - want).abs() <= ulp).all()


def test_sampler_core_on_cuda_equals_cpu(cuda):
    """The Fast R-CNN sampler's deterministic core on the same keys: the
    sampled indices, classes, boxes and validity equal on both devices
    (P = 4096 proposals, 512 slots, ties among the invalid ones)."""
    from drn_wsod_torch.models.heads import fast_rcnn as frcnn

    rs = np.random.RandomState(11)
    B, P, G = 2, 4096, 6
    props = _pyramid_boxes(rs, B * P, 800).reshape(B, P, 4)
    gt = _pyramid_boxes(rs, B * G, 800).reshape(B, G, 4)
    props[:, :300] = gt[:, rs.randint(G, size=300)] + torch.from_numpy(
        rs.uniform(-20, 20, (B, 300, 4)).astype(np.float32))
    args = (props, torch.from_numpy(rs.rand(B, P) > 0.1), gt,
            torch.from_numpy(rs.randint(0, 20, (B, G)).astype(np.int32)),
            torch.from_numpy(np.arange(G) < G - 1).expand(B, G),
            torch.from_numpy(rs.rand(B, P).astype(np.float32)),
            torch.from_numpy(rs.rand(B, P).astype(np.float32)))
    want = frcnn.subsample_proposals(*args)
    got = frcnn.subsample_proposals(*(a.to(cuda) for a in args))
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)
    assert (want.gt_class >= 0).sum(1).max() <= 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [False, True], ids=["v1", "v2"])
def test_roi_align_on_cuda_matches_cpu(cuda, aligned, dtype):
    """``roi_align`` at 600 RoIs (two chunks), sampling ratio 2, on the card
    and the CPU: float32 within 1e-6 of the largest value, bfloat16 within
    one ulp (each device rounds every operation alike)."""
    from drn_wsod_torch.ops.roi_align import roi_align

    rs = np.random.RandomState(12)
    feat = torch.from_numpy(rs.randn(21, 27, 64).astype(np.float32)).to(dtype)
    boxes = _pyramid_boxes(rs, 600, 27 * 8)
    want = roi_align(feat, boxes, 0.125, 7, 2, aligned=aligned)
    got = roi_align(feat.to(cuda), boxes.to(cuda), 0.125, 7, 2,
                    aligned=aligned)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-6 * want.abs().max().item())
    else:
        _within_bf16_ulp(got, want)


@pytest.mark.parametrize("pooler_type", ["ROIAlignV2", "ROIPool"])
def test_multilevel_roi_pool_on_cuda_matches_cpu(cuda, pooler_type):
    """The FPN pooler over p2-p5 of a 512x640 image (256 channels, bf16),
    1000 RoIs of every level: within one bfloat16 ulp of the CPU."""
    from drn_wsod_torch.ops.poolers import multilevel_roi_pool

    rs = np.random.RandomState(13)
    strides = {"p2": 4, "p3": 8, "p4": 16, "p5": 32}
    feats = {n: torch.from_numpy(rs.randn(512 // s, 640 // s, 256).astype(
        np.float32)).bfloat16() for n, s in strides.items()}
    boxes = _pyramid_boxes(rs, 1000, 640)
    names = list(strides)
    want = multilevel_roi_pool(feats, strides, boxes, names, 7, pooler_type,
                               2)
    got = multilevel_roi_pool({n: f.to(cuda) for n, f in feats.items()},
                              strides, boxes.to(cuda), names, 7, pooler_type,
                              2)
    _within_bf16_ulp(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("modulated", [False, True], ids=["v1", "v2"])
def test_deform_conv2d_on_cuda_matches_cpu(cuda, modulated, dtype):
    """``deform_conv2d`` at a res4-like 3x3 of 64 channels, dilation 2,
    offsets up to +-3 cells (taps off the map): float32 within rtol 1e-5,
    atol 1e-5 of the largest value (the contraction sums in another
    order; TF32 off), bfloat16 within one ulp."""
    from drn_wsod_torch.ops.deform_conv import deform_conv2d

    rs = np.random.RandomState(14)
    x = torch.from_numpy(rs.randn(2, 23, 29, 64).astype(np.float32)).to(dtype)
    off = torch.from_numpy((rs.randn(2, 23, 29, 18) * 1.5).astype(np.float32))
    w = torch.from_numpy((rs.randn(64, 64, 3, 3) / 24).astype(
        np.float32)).to(dtype)
    mod = (torch.from_numpy(rs.rand(2, 23, 29, 9).astype(np.float32))
           if modulated else None)
    want = deform_conv2d(x, off, w, mod, dilation=2)
    got = deform_conv2d(x.to(cuda), off.to(cuda), w.to(cuda),
                        None if mod is None else mod.to(cuda), dilation=2)
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())
    else:
        _within_bf16_ulp(got, want)


# ---------------------------------------------------- mask and keypoint arms
def _dense_batches(n=3, K=17):
    """``_head_batches`` with instance GT near proposals 2 and 5 (1 to 4
    foreground proposals an image, so every valid proposal fills the 16
    slots whatever the device's generator draws), a polygon mask and 17
    keypoints per GT slot."""
    from drn_wsod_torch.structures.boxes import pairwise_iou
    from drn_wsod_torch.structures.masks import fill_polygon

    out = []
    for s, b in enumerate(_head_batches(n)):
        rng = np.random.RandomState(100 + s)
        props = b.proposals.numpy()
        gt = np.zeros((2, 3, 4), np.float32)
        gt[:, 0] = props[:, 2] + rng.uniform(-1.5, 1.5, (2, 4))
        gt[:, 1] = props[:, 5] + rng.uniform(-1.5, 1.5, (2, 4))
        masks = np.zeros((2, 3, 64, 64), bool)
        kps = np.zeros((2, 3, K, 3), np.float32)
        for i in range(2):
            for g in range(2):
                x1, y1, x2, y2 = gt[i, g]
                ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
                fill_polygon(masks[i, g], np.stack(
                    [(x1 + x2) / 2 + (x2 - x1) / 2 * np.cos(ang),
                     (y1 + y2) / 2 + (y2 - y1) / 2 * np.sin(ang)], -1))
                kps[i, g, :, 0] = rng.uniform(x1, x2, K)
                kps[i, g, :, 1] = rng.uniform(y1, y2, K)
                kps[i, g, :, 2] = rng.randint(0, 3, K)
        b = b.replace(gt_boxes=torch.from_numpy(gt),
                      gt_classes=torch.from_numpy(
                          rng.randint(0, 20, (2, 3)).astype(np.int32)),
                      gt_valid=torch.tensor([[True, True, False]] * 2),
                      gt_masks=torch.from_numpy(masks.view(np.uint8)),
                      gt_keypoints=torch.from_numpy(kps))
        iou = pairwise_iou(b.gt_boxes[:, :2], b.proposals)
        n_fg = (torch.where(b.proposal_mask, iou.max(1).values, 0.0)
                >= 0.5).sum(1)
        assert ((n_fg >= 1) & (n_fg <= 4)).all(), n_fg
        out.append(b)
    return out


def _dense_cfg(*extra):
    return _toy_cfg("MODEL.ROI_HEADS.NAME", "StandardROIHeads",
                    "MODEL.MASK_ON", "True", "MODEL.KEYPOINT_ON", "True",
                    "MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", "7",
                    "MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION", "7",
                    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16", *extra)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_mask_and_keypoint_heads_on_cuda_match_cpu(cuda, dtype):
    """Both heads at their full widths (4 x 256 to 80 classes; 8 x 512 to
    17 keypoints) on 64 RoIs of 14 x 14 x 256: cuDNN against the CPU from
    the same weights, float32 within 1e-4 of the largest logit, bfloat16
    convs within four bfloat16 ulps of it."""
    from drn_wsod_torch.models.heads.keypoint import \
        KRCNNConvDeconvUpsampleHead
    from drn_wsod_torch.models.heads.seg import MaskRCNNHead

    x = torch.from_numpy(np.random.RandomState(0).randn(
        64, 14, 14, 256).astype(np.float32))
    for head in (MaskRCNNHead(256, 80, dtype=dtype),
                 KRCNNConvDeconvUpsampleHead(256, 17, dtype=dtype)):
        head.init_weights(torch.Generator().manual_seed(1))
        with torch.no_grad():
            want = head(x)
            got = head.to(cuda)(x.to(cuda)).cpu()
        assert got.shape == want.shape and got.dtype == torch.float32
        top = want.abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else \
            4 * 2.0 ** (np.floor(np.log2(top)) - 7) / top
        assert (got - want).abs().max().item() <= tol * top


def test_toy_mask_keypoint_steps_on_cuda_match_cpu(cuda):
    """Three Fast R-CNN steps with the mask and keypoint arms on the card
    and on the CPU from the same weights: every loss (``loss_mask`` and
    ``loss_keypoint`` among them) within rtol 1e-4."""
    cfg = _dense_cfg()
    models = {"cpu": drn_wsod_torch.build_model(cfg, device="cpu")}
    models["cuda"] = drn_wsod_torch.build_model(cfg, device=cuda)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    metrics = {}
    for dev, model in models.items():
        tx = drn_wsod_torch.build_optimizer(cfg, model)
        state = drn_wsod_torch.create_train_state(model, tx)
        step = drn_wsod_torch.make_train_step(model, tx)
        metrics[dev] = []
        for b in _dense_batches():
            state, m = step(state, b.to(model.pixel_mean.device), 0)
            metrics[dev].append({k: v.item() for k, v in m.items()})
    for want, got in zip(metrics["cpu"], metrics["cuda"]):
        assert {"loss_mask", "loss_keypoint"} <= want.keys() == got.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_detect_masks_and_keypoints_on_cuda_match_cpu(cuda):
    """``make_detect_fn`` with both arms on the card against the CPU: the
    detections, their mask probabilities and keypoint scores within 1e-4
    (the decoded locations are an argmax of near-equal logits on random
    weights, and are not compared)."""
    cfg = _dense_cfg()
    cpu_model = drn_wsod_torch.build_model(cfg, device="cpu")
    card_model = drn_wsod_torch.build_model(cfg, device=cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    b = _dense_batches(1)[0]
    out = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        detect = drn_wsod_torch.make_detect_fn(
            model, 1e-5, 0.5, 8, device=dev, mask_on=True, keypoint_on=True)
        out[dev] = {k: v.cpu().numpy() for k, v in detect(b).items()}
    want, got = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["classes"], want["classes"])
    for k in ("scores", "boxes", "mask_probs"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["keypoints"][..., 2],
                               want["keypoints"][..., 2], rtol=1e-4,
                               atol=1e-6)
    assert got["mask_probs"].shape == (2, 8, 14, 14)
    assert got["keypoints"].shape == (2, 8, 17, 3)


# ------------------------------------------------------------- dense models
def test_dense_heads_on_cuda_match_cpu(cuda):
    """RetinaNet's head (4 + 4 convs of 256, 9 x 80 and 9 x 4 predictors)
    and the SemSegFPN head (128 wide, GroupNorm, 54 classes) at their full
    widths on small pyramids: cuDNN against the CPU from the same weights
    in float32, within 1e-4 of each output's largest."""
    from drn_wsod_torch.models.heads.seg import SemSegFPNHead
    from drn_wsod_torch.models.retinanet import RetinaNetHead

    rs = np.random.RandomState(0)
    feats = [torch.from_numpy(rs.randn(2, 256, s, s).astype(np.float32))
             for s in (32, 16, 8, 4)]
    retina = RetinaNetHead(256, 80, 9)
    retina.init_weights(torch.Generator().manual_seed(1))
    sem = SemSegFPNHead([256] * 4, ("p2", "p3", "p4", "p5"), (4, 8, 16, 32),
                        54)
    sem.init_weights(torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = [t for pair in retina(feats) for t in pair] + [sem(feats)]
        on_card = [f.to(cuda) for f in feats]
        got = [t for pair in retina.to(cuda)(on_card) for t in pair] + [
            sem.to(cuda)(on_card)]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        top = w.abs().max().item()
        assert (g.cpu() - w).abs().max().item() <= 1e-4 * top


_DENSE_YAMLS = {
    "retinanet": ("quick_schedules/retinanet_R_50_instant_test.yaml",
                  # one square power-of-two anchor a cell: anchors tied at a
                  # GT's best IoU tie on both devices
                  ["MODEL.ANCHOR_GENERATOR.SIZES", "[[16], [32], [64], [128]]",
                   "MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS", "[[1.0]]",
                   "MODEL.RETINANET.NUM_CLASSES", "20"]),
    "semantic": ("Misc/semantic_R_50_FPN_1x.yaml",
                 ["MODEL.SEM_SEG_HEAD.NUM_CLASSES", "5"]),
    "panoptic": ("Misc/panoptic_fpn_R_50_1x.yaml",
                 ["MODEL.ROI_HEADS.NUM_CLASSES", "20",
                  "MODEL.SEM_SEG_HEAD.NUM_CLASSES", "5",
                  "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16"])}


@pytest.mark.parametrize("case", sorted(_DENSE_YAMLS))
def test_toy_dense_steps_on_cuda_match_cpu(cuda, case):
    """Three steps of RetinaNet, the SemanticSegmentor and PanopticFPN (R18
    FPN 32, float32, the semantic head 16 wide, PanopticFPN's mask pool at
    7, BASE_LR 0.002) on the card and on the CPU from the same weights, on
    ``_dense_batches`` with label maps (every valid proposal fills the 16
    slots whatever the device's generator draws): every loss within rtol
    1e-4."""
    from pathlib import Path

    yaml, extra = _DENSE_YAMLS[case]
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs"
                            / yaml))
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.FPN.OUT_CHANNELS", "32",
                         "MODEL.SEM_SEG_HEAD.CONVS_DIM", "16",
                         "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", "4",
                         "MODEL.PIXEL_STD", "[57.4, 57.1, 58.4]",
                         # the YAMLs' 0.01-0.02 on random weights grow the
                         # two devices' summation orders past 1e-4 within
                         # three steps
                         "SOLVER.BASE_LR", "0.002",
                         "MODEL.DTYPE", "float32", *extra])
    models = {"cpu": drn_wsod_torch.build_model(cfg, device="cpu")}
    models["cuda"] = drn_wsod_torch.build_model(cfg, device=cuda)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    rs = np.random.RandomState(5)
    batches = [b.replace(sem_seg=torch.from_numpy(
        rs.randint(0, 5, (2, 64, 64)).astype(np.int32)))
        for b in _dense_batches()]
    metrics = {}
    for dev, model in models.items():
        if case == "panoptic":
            model.mask_pooler_resolution = 7
        tx = drn_wsod_torch.build_optimizer(cfg, model)
        state = drn_wsod_torch.create_train_state(model, tx)
        step = drn_wsod_torch.make_train_step(model, tx)
        metrics[dev] = []
        for b in batches:
            state, m = step(state, b.to(model.pixel_mean.device), 0)
            metrics[dev].append({k: v.item() for k, v in m.items()})
    for want, got in zip(metrics["cpu"], metrics["cuda"]):
        assert want.keys() == got.keys() and len(want) > 1
        for k in want:
            assert np.isfinite(want[k])
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def _rotated(rs, n, hi=120.0):
    return torch.from_numpy(np.stack([
        rs.uniform(0, hi, n), rs.uniform(0, hi, n), rs.uniform(4, 50, n),
        rs.uniform(4, 50, n), rs.uniform(-180, 180, n)], -1).astype(
            np.float32))


def test_rotated_iou_on_cuda_matches_cpu(cuda):
    """Within 1e-6 (the two devices' ``cos`` and ``atan2`` may round
    apart); a chunk size changes nothing on the card."""
    from drn_wsod_torch.structures import rotated_boxes as rb

    rs = np.random.RandomState(0)
    a, b = _rotated(rs, 64), _rotated(rs, 48)
    want = rb.pairwise_iou_rotated(a, b)
    got = rb.pairwise_iou_rotated(a.to(cuda), b.to(cuda))
    assert (want > 0).sum() > 20
    assert (got.cpu() - want).abs().max().item() <= 1e-6
    assert torch.equal(rb.pairwise_iou_rotated(a.to(cuda), b.to(cuda),
                                               chunk=97), got)


def test_roi_align_rotated_on_cuda_matches_cpu(cuda):
    """float32 within 1e-5; bfloat16 within one bf16 ulp."""
    from drn_wsod_torch.ops.roi_align_rotated import roi_align_rotated

    rs = np.random.RandomState(1)
    feat = torch.from_numpy(rs.randn(24, 20, 16).astype(np.float32))
    rois = _rotated(rs, 70, hi=90.0)
    for dtype in (torch.float32, torch.bfloat16):
        want = roi_align_rotated(feat.to(dtype), rois, 0.25, 7, 2,
                                 chunk=32).float()
        got = roi_align_rotated(feat.to(dtype).to(cuda), rois.to(cuda),
                                0.25, 7, 2, chunk=32).float().cpu()
        diff = (got - want).abs()
        if dtype == torch.float32:
            assert diff.max().item() <= 1e-5
        else:
            ulp = torch.exp2(torch.floor(torch.log2(
                want.abs().clamp(min=1e-30))) - 7)
            assert bool((diff <= ulp).all())


def _clear(iou, valid, ties):
    iou = iou[valid]
    ok = not bool(((iou[..., None] - torch.tensor([0.3, 0.7],
                                                  dtype=iou.dtype)).abs()
                   < 1e-4).any())
    if ties:
        top2 = iou.topk(2, dim=1).values
        ok &= bool((top2[:, 0] - top2[:, 1] > 1e-4).all())
    return ok


@pytest.mark.parametrize("rotated", [False, True], ids=["rpn", "rrpn"])
def test_rpn_losses_on_cuda_match_cpu(cuda, rotated):
    """``rpn_losses`` / ``rrpn_losses`` on the card against the CPU on the
    same float32 inputs and keys: the sampled anchors equal, the losses
    within rtol 1e-5. The GT keeps every IoU 1e-4 from the thresholds and
    each GT's best anchor 1e-4 above its second (RRPN's low-quality
    match), so float32 rounding decides no label; the rotated anchors turn
    by (-60, 0, 60), which gives no anchor a geometric twin."""
    from drn_wsod_torch.models import proposal_generator as pg
    from drn_wsod_torch.structures import boxes as box_ops
    from drn_wsod_torch.structures import rotated_boxes as rb

    rs = np.random.RandomState(2)
    if rotated:
        anchors = pg.generate_rotated_anchors((16, 16), 8, (16.0,),
                                              (0.5, 1.0, 2.0),
                                              (-60.0, 0.0, 60.0))
    else:
        anchors = pg.generate_anchors((16, 16), 8, (16.0, 32.0),
                                      (0.5, 1.0, 2.0))
    valid = torch.tensor([True, True, True, False])
    while True:
        if rotated:
            gt = torch.from_numpy(np.stack([
                rs.uniform(16, 112, 4), rs.uniform(16, 112, 4),
                rs.uniform(10, 30, 4), rs.uniform(10, 30, 4),
                rs.uniform(-20, 20, 4)], 1).astype(np.float32))
            iou = rb.pairwise_iou_rotated(gt.double(), anchors.double())
        else:
            xy = rs.uniform(0, 100, (4, 2))
            gt = torch.from_numpy(np.concatenate(
                [xy, xy + rs.uniform(10, 40, (4, 2))], 1).astype(np.float32))
            iou = box_ops.pairwise_iou(gt.double(), anchors.double())
        if _clear(iou, valid, rotated) and (rotated or bool(
                (iou[valid] >= 0.7).any())):
            break
    n, d = anchors.shape
    logits = torch.from_numpy(rs.randn(n).astype(np.float32))
    deltas = torch.from_numpy((rs.randn(n, d) * 0.2).astype(np.float32))
    keys = tuple(torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32))
                 for _ in range(2))
    fn = pg.rrpn_losses if rotated else pg.rpn_losses
    want = fn(anchors, logits, deltas, gt, valid, keys, batch_size=64,
              return_sampled=True)
    got = fn(anchors.to(cuda), logits.to(cuda), deltas.to(cuda), gt.to(cuda),
             valid.to(cuda), tuple(k.to(cuda) for k in keys), batch_size=64,
             return_sampled=True)
    for g, w in zip(got[2], want[2]):
        assert torch.equal(g.cpu(), w)
    assert int(want[2][2].sum()) > 0
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.item(), w.item(), rtol=1e-5)


# ------------------------------------------------- several processes
def _dist_case(cfg, batches, axes, shape, **kw):
    return {"kind": "steps", "cfg": cfg.dump(), "state_dict": None,
            "batches": [b.tensors() for b in batches], "axes": axes,
            "shape": shape, **kw}


def _dist_batches(n=3, batch=4):
    return [drn_wsod_torch.synthetic_batch(batch, 64, 64, 16, 20,
                                           seed=40 + s, device="cpu")
            for s in range(n)]


def test_world_1_nccl_sharded_step_is_the_plain_step(cuda, tmp_path):
    """NCCL at world size 1 on the card: ``make_sharded_train_step`` (the
    coalesced gradient ``all_reduce`` and the global normalisers through a
    one-rank NCCL group) for 3 toy steps, dropout 0.5, is bit-equal to
    ``make_train_step`` from the same init: every loss and the digest of
    every parameter and buffer after every step."""
    from torch_dist_worker import launch

    cfg = _toy_cfg("MODEL.ROI_BOX_HEAD.DROPOUT", "0.5")
    res = launch({"backend": "nccl", "cases": {"nccl": _dist_case(
        cfg, _dist_batches(), ("data",), (1,), plain_too=True)}}, 1,
        tmp_path, timeout=300, device="cuda")
    got = res[0]["nccl"]
    assert got["metrics"] == got["plain_metrics"]
    assert got["digests"] == got["plain_digests"]


def _matches_one_process(cuda, cfg, batches, got):
    """Each rank-0 loss within rtol 1e-4 and the trainable parameters
    within 1e-6 + 1e-4 |p| of one process's steps on the global batches on
    card 0 (float summation order only)."""
    model = drn_wsod_torch.build_model(cfg, device=cuda)
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    step = drn_wsod_torch.make_train_step(model, tx)
    for b, g in zip(batches, got["metrics"]):
        state, m = step(state, b.to(cuda), 0)
        for k, v in m.items():
            np.testing.assert_allclose(g[k], v.item(), rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    sd = model.state_dict()
    for k, v in got["state_dict"].items():
        np.testing.assert_allclose(v.numpy(), sd[k].cpu().numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on the one card, ``("data",) = (2,)``, 3 toy steps,
    dropout 0.5: against one process on the rank-major global batch
    (``_matches_one_process``), and both ranks' parameters and buffers
    bit-equal after every step."""
    from torch_dist_worker import launch

    cfg = _toy_cfg("MODEL.ROI_BOX_HEAD.DROPOUT", "0.5")
    batches = _dist_batches()
    res = launch({"cases": {"dp": _dist_case(cfg, batches, ("data",),
                                              (2,))}}, 2, tmp_path,
                 timeout=300, device="cuda")
    _matches_one_process(cuda, cfg, batches, res[0]["dp"])
    assert res[0]["dp"]["digests"] == res[1]["dp"]["digests"]


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two CUDA devices or more: NCCL puts no "
                           "two ranks on one device")
@pytest.mark.parametrize("model_size", [1, 2], ids=["data", "data_model"])
def test_nccl_across_cards(cuda, tmp_path, model_size):
    """NCCL over every card of the machine, one rank a card: ``("data",)
    = (N,)`` and ``("data", "model") = (N/2, 2)`` (the DAN split), 3 toy
    steps, dropout 0.5, a global batch of N * max(1, 4 // N) images:
    against one process (``_matches_one_process``), and every rank's
    parameters and buffers bit-equal after every step."""
    from torch_dist_worker import launch

    world = torch.cuda.device_count()
    if world % model_size:
        pytest.skip(f"{world} cards do not split into model groups of 2")
    cfg = _toy_cfg("MODEL.ROI_BOX_HEAD.DROPOUT", "0.5")
    batches = _dist_batches(batch=world * max(1, 4 // world))
    if model_size == 1:
        axes, shape = ("data",), (world,)
    else:
        axes, shape = ("data", "model"), (world // 2, 2)
    res = launch({"backend": "nccl", "cases": {"run": _dist_case(
        cfg, batches, axes, shape)}}, world, tmp_path, timeout=300,
        device="cuda", one_card_each=True)
    _matches_one_process(cuda, cfg, batches, res[0]["run"])
    assert len({r["run"]["digests"][-1] for r in res}) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_k1_library_op_on_cuda_equals_plain(cuda, dtype):
    """``torch.ops.drn_wsod.roi_pool_batched`` on CUDA tensors launches
    K1 once and equals the plain version on the CPU copies."""
    feat, boxes, scale = _inputs(cuda, dtype, seed=4)
    before = rp.roi_pool_batched.launches
    got = torch.ops.drn_wsod.roi_pool_batched(feat, boxes, 0.125, 7, scale)
    torch.cuda.synchronize()
    assert rp.roi_pool_batched.launches == before + 1
    want = rp.roi_pool_plain(feat.cpu(), boxes.cpu(), 0.125, 7, scale.cpu())
    assert got.dtype == dtype and got.is_cuda
    assert torch.equal(got.cpu(), want)


def test_export_on_cuda(cuda):
    """The toy flagship exported on the card: the graph holds K1, the
    loaded program launches it once a call and equals the live model bit
    for bit, and the live model on the card the CPU's within the slice
    tolerance."""
    from drn_wsod_torch.export import (export_inference, holds_roi_pool,
                                       load_exported)

    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file("configs/PascalVOC-Detection/oicr_WSR_50_DC5_1x.yaml")
    cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "18",
                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
                         "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]",
                         "MODEL.DTYPE", "float32"])
    model = drn_wsod_torch.build_model(cfg, device=cuda)
    batch = drn_wsod_torch.synthetic_batch(2, 96, 96, 64, 20, seed=2,
                                           device=cuda)
    program = load_exported(export_inference(model, batch))
    assert holds_roi_pool(program.program) == 1
    before = rp.roi_pool_batched.launches
    got = program.call(batch)
    torch.cuda.synchronize()
    assert rp.roi_pool_batched.launches == before + 1
    live = model.inference_scores(batch)
    for g, w in zip(got, live):
        assert g.is_cuda and torch.equal(g, w)
    cpu = model.to("cpu").inference_scores(batch.to("cpu"))
    for g, w in zip(got, cpu):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize("dropout", [0.0, 0.5],
                         ids=["dropout0", "dropout0.5"])
def test_data_parallel_full_width_is_float_order(cuda, tmp_path, dropout):
    """The flagship at full width in float32 (R50-WS DC5, DAN [2048,
    4096], 704^2, P = 4096, dropout 0 and the YAML's 0.5), 3 steps
    data-parallel over four ranks, one image a rank (NCCL, one rank a
    card, on four cards or more; else four gloo ranks sharing card 0),
    against one process on the same 3 global batches of 4 on card 0, run
    twice: as it is, and with every ``Dense`` product (the DAN's and the
    predictors') taken image by image, as the ranks take them. The two
    processes compute the same sums blocked otherwise: their gap is float
    order alone. Holds: the backbone's features of each image are the same
    bits at B = 1 as at B = 4 (its batching parts nothing); every loss
    within rtol 1e-4; each tensor of the ranks within phase 27's 1e-6 +
    1e-4 |p| of the process as it is, or else of the blocked one. Prints
    the worst of each and the gap blocking alone opens. Minutes long:
    ``chip_smoke.py`` phase 9 leaves it to a call of its own."""
    from torch_dist_worker import launch

    from drn_wsod_torch.models.layers import Dense

    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file("configs/PascalVOC-Detection/oicr_WSR_50_DC5_1x.yaml")
    cfg.merge_from_list(["MODEL.DTYPE", "float32",
                         "MODEL.ROI_BOX_HEAD.DROPOUT", str(dropout)])
    batches = [drn_wsod_torch.synthetic_batch(4, 704, 704, 4096, 20,
                                              seed=60 + s, device="cpu")
               for s in range(3)]
    cards = torch.cuda.device_count() >= 4
    payload = {"cases": {"dp": _dist_case(cfg, batches, ("data",), (4,))}}
    if cards:
        payload["backend"] = "nccl"
    res = launch(payload, 4, tmp_path, timeout=900, device="cuda",
                 one_card_each=cards)
    ranks = res[0]["dp"]
    where = "four cards, NCCL" if cards else "one card, four gloo ranks"
    forward = Dense.forward

    def by_image(self, x):
        # the rows are image-major: each image's rows multiplied alone
        return torch.cat([forward(self, rows) for rows in x.chunk(4)])

    def one_process(blocked: bool):
        model = drn_wsod_torch.build_model(cfg, device=cuda)
        tx = drn_wsod_torch.build_optimizer(cfg, model)
        state = drn_wsod_torch.create_train_state(model, tx)
        step = drn_wsod_torch.make_train_step(model, tx)
        metrics = []
        with mock.patch.object(Dense, "forward",
                               by_image if blocked else forward):
            for b in batches:
                state, m = step(state, b.to(cuda), 0)
                metrics.append({k: v.item() for k, v in m.items()})
        sd = {k: v.cpu() for k, v in model.state_dict().items()}
        del model, state
        torch.cuda.empty_cache()
        return metrics, sd

    model = drn_wsod_torch.build_model(cfg, device=cuda)
    with torch.no_grad():
        x = model.preprocess(batches[0].image.to(cuda)).permute(0, 3, 1, 2)
        whole = model.backbone(x)
        for i in range(x.shape[0]):
            one = model.backbone(x[i:i + 1])
            for k in whole:
                assert torch.equal(one[k][0], whole[k][i]), (k, i)
    del model, x, whole, one
    torch.cuda.empty_cache()

    metrics, sd = one_process(False)
    _, sd_blocked = one_process(True)
    loss = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
               for g, w in zip(ranks["metrics"], metrics) for k in w)

    def tol(a, b):
        return ((a - b).abs() / (1e-6 + 1e-4 * b.abs())).max().item()
    worst, bad = (None, 0.0, 0.0, 0.0, 0.0), []
    for k, v in ranks["state_dict"].items():
        plain, blocked = tol(v, sd[k]), tol(v, sd_blocked[k])
        if plain > worst[1]:
            worst = (k, plain, (v - sd[k]).abs().max().item(), blocked,
                     (sd_blocked[k] - sd[k]).abs().max().item())
        if plain > 1.0 and blocked > 1.0:
            bad.append((k, plain, blocked))
    print(f"data-parallel over 4 ranks ({where}, dropout {dropout}) vs "
          f"one process: losses rel {loss:.3g}; worst tensor {worst[0]}: "
          f"{worst[1]:.3g} x (1e-6 + 1e-4 |p|), max|diff| {worst[2]:.3g}; "
          f"{worst[3]:.3g} x against the process with its products blocked "
          f"by image, which blocking alone moves by {worst[4]:.3g}")
    assert loss < 1e-4 and not bad, bad


def test_pool_sweep_kernels_exact_on_both_mixes(cuda):
    """``tools/pool_sweep.py`` at a small P on the card: K1 in both launch
    orders and K3 equal to the plain version on the uniform and the
    VOC-like mix, each variant launched once a call."""
    from drn_wsod_torch.tools import pool_sweep

    k1, k3 = rp.roi_pool_batched.launches, dict(rp.roi_pool_banded.launches)
    rows = pool_sweep.run(iters=2, device=cuda, B=2, S=704, P=256, C=64)
    assert [r.mix for r in rows] == ["uniform", "voc"]
    for r in rows:
        assert r.max_diff == {"K1 top-row order": 0.0, "K1 RoI order": 0.0,
                              "K3 banded": 0.0}, r.mix
        assert r.bound_ms > 0 and all(ms > 0 for ms in r.ms.values())
    banded = sum(r.calls for r in rows)
    assert rp.roi_pool_batched.launches - k1 == 2 * banded
    assert {k: v - k3[k] for k, v in rp.roi_pool_banded.launches.items()} \
        == {"roi_pool_banded": banded, "roi_pool_banded_rest": banded}
