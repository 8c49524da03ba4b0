"""CUDA-only tests: the hand-written RoIPool kernel against its plain
version on the card, and the toy detect path on the card against the CPU.
They skip where no CUDA device exists (the kernel has no CPU mode); run
them on a GPU machine with ``python -m pytest tests/test_torch_cuda.py``."""

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
