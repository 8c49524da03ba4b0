"""The FLOP formula equals ``torch.utils.flop_counter.FlopCounterMode``
over the plain reference at a small size, in training and in inference."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import harness
from h100_bench.flops import image_flops
from h100_bench.reference import arch as arch_lib
from h100_bench.reference.model import Reference
from h100_bench.small import SMALL


def _setup(B, H, W, P):
    arch = arch_lib.from_config(harness.load_config("oicr_r50",
                                                    SMALL)["merged"])
    Wt = harness.make_weights(arch_lib.leaves(arch), 3, torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    xy = torch.rand(B, P, 2, generator=g) * torch.tensor([W / 2, H / 2])
    wh = torch.rand(B, P, 2, generator=g) * torch.tensor([W / 2, H / 2]) + 4
    batch = {"image": torch.randint(0, 256, (B, H, W, 3), dtype=torch.uint8,
                                    generator=g),
             "proposals": torch.cat([xy, xy + wh], -1),
             "proposal_mask": torch.ones(B, P, dtype=torch.bool),
             "objectness": torch.rand(B, P, generator=g),
             "labels": (torch.rand(B, arch.num_classes, generator=g) < 0.3
                        ).float()}
    batch["labels"][:, 0] = 1.0
    return arch, Wt, batch


def test_train_flops():
    B, H, W, P = 2, 64, 96, 48
    arch, Wt, batch = _setup(B, H, W, P)
    params = {n: Wt[n].requires_grad_(True) for n in Wt
              if n.startswith(("box_head.", "box_predictor.",
                               "box_refinery."))}
    ref = Reference(arch, Wt)
    with FlopCounterMode(display=False) as fc:
        losses = ref.losses(batch, torch.Generator().manual_seed(1))
        total = sum(losses.values())
        torch.autograd.grad(total, list(params.values()), allow_unused=True)
    assert fc.get_total_flops() == B * image_flops(arch, H, W, P, True)


def test_eval_flops():
    B, H, W, P = 3, 96, 64, 40
    arch, Wt, batch = _setup(B, H, W, P)
    ref = Reference(arch, Wt)
    with FlopCounterMode(display=False) as fc:
        ref.inference_scores(batch)
    assert fc.get_total_flops() == B * image_flops(arch, H, W, P, False)


def test_padding_is_not_counted():
    arch, _, _ = _setup(1, 32, 32, 1)
    assert image_flops(arch, 375, 500, 10, False) == \
        image_flops(arch, 384, 512, 10, False)
    assert image_flops(arch, 384, 512, 20, True) > \
        image_flops(arch, 384, 512, 10, True)
