"""The port's train-step ablation tool (``drn_wsod_torch.tools.
ablate_bench``) on the CPU at a toy size: every part of the JAX tool's
table runs, in its order, with a timer that only counts calls (no time is
measured here: the tool's times come from CUDA events on the card)."""

import pytest
import torch

from drn_wsod_torch.tools import ablate_bench

torch.set_num_threads(1)

TOY = ["MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
       "MODEL.ROI_BOX_HEAD.DAN_DIM", "[64, 64]", "MODEL.DTYPE", "float32"]
# the JAX tool's parts (tools/ablate_bench.py), in order, with K2's int8
# mode added after its float mode
PARTS = ["full train step (B=2)", "forward loss only",
         "forward+backward (no opt)", "inference_scores fwd",
         "10 steps back to back (total)", "  -> per step",
         "K1 pool, batched kernel (B=2)", "K2 pool, looped per image (B=2)",
         "K2 pool, looped per image, int8 (B=2)", "FC1 fwd alone",
         "FC1 wgrad alone", "optimizer update alone",
         "train step WSDDN-only (no OICR)"]


@pytest.fixture(scope="module")
def rows():
    calls = []

    def counting_timer(fn, iters):
        for _ in range(iters + 1):
            fn()
        calls.append(iters + 1)
        return float(len(calls))

    emitted = []
    out = ablate_bench.run(iters=2, device="cpu", B=2, H=64, P=16,
                           overrides=TOY, timer=counting_timer,
                           emit=emitted.append)
    assert emitted == out
    return out, calls


def test_every_part_in_order(rows):
    out, _ = rows
    assert [r.name for r in out] == PARTS


def test_calls_and_derived_row(rows):
    out, calls = rows
    timed = [r for r in out if r.calls]
    assert [r.calls for r in timed] == calls
    total, per_step = out[4], out[5]
    assert per_step.calls == 0 and per_step.ms == total.ms / 10


def test_pool_inputs_repeat_one_image_from_the_seed():
    # chip_smoke.py holds K2 against its plain version on these inputs, so
    # the same arguments must give the same tensors
    proposals = torch.rand(2, 16, 4) * 64
    feats, boxes, scale = ablate_bench.pool_inputs(proposals, 64, C=16)
    again = ablate_bench.pool_inputs(proposals, 64, C=16)
    assert feats.shape == (2, 8, 8, 16) and feats.dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip((feats, boxes, scale),
                                                 again))
    assert torch.equal(feats[0], feats[1]) and feats.is_contiguous()
    assert torch.equal(boxes, proposals[0].expand(2, 16, 4))
    assert torch.equal(scale, torch.ones(2, 16))


def test_row_format_carries_the_card():
    row = ablate_bench.Row("FC1 fwd alone", 4.125, 11)
    line = ablate_bench.format_row(row, "[NVIDIA H100 80GB HBM3, 700.00 W]")
    assert line.startswith("FC1 fwd alone ") and "4.125 ms" in line
    assert line.endswith("[NVIDIA H100 80GB HBM3, 700.00 W]")
