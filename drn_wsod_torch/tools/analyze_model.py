"""Model analysis: parameter counts by top-level module and the forward's
FLOPs (counterpart of ``tools/analyze_model.py``).

    python -m drn_wsod_torch.tools.analyze_model [--config-file CONFIG] \\
        [--image-size 704] [KEY VALUE ...]

Parameters: every tensor of the model's state dict (weights and the
FrozenBN statistics, which the JAX package keeps among its ``params``),
grouped by the top-level module under the JAX package's names (a list's
k-th entry ``name.k`` is ``name_k``), so the counts equal the JAX tool's.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over
``inference_scores`` of a synthetic batch (B = 1, the image size square,
``ROI_HEADS.BATCH_SIZE_PER_IMAGE`` proposals) on zero weights. It counts
2 x the multiply-adds of the matrix products and convolutions that torch
dispatches (``mm``, ``addmm``, ``bmm``, ``convolution`` and their kin),
and nothing else: elementwise ops, reductions, K1 and NMS count zero. The
JAX tool prints XLA's cost analysis of the compiled program, which counts
every op, so the two totals differ by what this one leaves out. Torch has
no counterpart of XLA's "bytes accessed", so none is printed. Runs on the
CUDA device unless ``main`` is given another one (the meta device counts
without memory or time).
"""

from __future__ import annotations

import argparse
from collections import Counter
from typing import Dict, Tuple

import torch


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch analyze_model")
    p.add_argument("--config-file", default="")
    p.add_argument("--image-size", type=int, default=704)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def parameter_counts(model: torch.nn.Module) -> Dict[str, int]:
    """{top-level module, under the JAX package's name: tensor elements}
    over the state dict."""
    counts = Counter()
    for name, t in model.state_dict().items():
        parts = name.split(".")
        top = (f"{parts[0]}_{parts[1]}" if len(parts) > 2
               and parts[1].isdigit() else parts[0])
        counts[top] += t.numel()
    return dict(counts)


def forward_flops(model: torch.nn.Module, batch) -> int:
    """FLOPs ``FlopCounterMode`` counts over ``inference_scores``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        model.inference_scores(batch)
    return counter.get_total_flops()


def main(argv=None, device=None) -> Tuple[Dict[str, int], int]:
    """Print and return (the counts by module, the forward FLOPs)."""
    from ..config import get_cfg
    from ..models import build_model
    from ..synthetic import synthetic_batch

    args = argument_parser().parse_args(argv)
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    model = build_model(cfg, device=device)
    counts = parameter_counts(model)
    total = sum(counts.values())
    print("Parameters:")
    for k, v in sorted(counts.items(), key=lambda kv: -kv[1]):
        print(f"  {k:24s} {v / 1e6:10.2f} M")
    print(f"  {'TOTAL':24s} {total / 1e6:10.2f} M")

    dev = next(model.parameters()).device
    with torch.no_grad():
        for t in model.state_dict().values():
            t.zero_()
    batch = synthetic_batch(B=1, H=args.image_size, W=args.image_size,
                            P=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
                            C=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
                            device="cpu").to(dev)
    flops = forward_flops(model, batch)
    print(f"Forward FLOPs (torch.utils.flop_counter.FlopCounterMode: "
          f"matrix products and convolutions): {flops / 1e9:.2f} G")
    print("Bytes accessed: not measured (torch has no counterpart of XLA's "
          "cost analysis)")
    return counts, flops


if __name__ == "__main__":
    main()
