"""Ablation timings of the flagship train step (counterpart of the JAX
package's ``tools/ablate_bench.py``): where the step's milliseconds go.

    python -m drn_wsod_torch.tools.ablate_bench [--iters N]

Runs on one CUDA device, the flagship config (R50-WS DC5, DAN [2048, 4096],
WSDDN + 3 OICR branches, bf16, dropout 0.5) with seeded random weights and
a synthetic batch of B=2 704x704 images with P=4096 proposals, and times,
in the JAX tool's order: the full train step, the forward loss alone,
forward + backward without the optimizer, ``inference_scores``, 10 steps
back to back, the batched RoIPool kernel (K1) at B=2, the single-image
kernel (K2) looped per image in float mode and in int8 mode (the JAX tool
times float only: the TPU never compiled int8), fc1's forward product and
its weight gradient alone, the optimizer update alone, and the WSDDN-only
train step. The pool rows use the tool's own 88x88x2048 map (704 / 8).

Every time is the device time per call from CUDA events around ``iters``
calls after one warm-up call; each line carries the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path
from typing import Callable, List, Optional

import torch

FLAGSHIP = str(Path(__file__).resolve().parents[2] / "configs"
               / "PascalVOC-Detection" / "oicr_WSR_50_DC5_1x.yaml")


@dataclasses.dataclass
class Row:
    name: str
    ms: float      # device ms per call
    calls: int     # calls made, warm-up included (0: a derived row)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Device ms per call of ``fn``: one warm-up call, then CUDA events
    around ``iters`` calls."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flagship_cfg(cfg_file: str = FLAGSHIP, overrides=()):
    from drn_wsod_torch import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(cfg_file)
    cfg.merge_from_list(list(overrides))
    return cfg


def pool_inputs(proposals: torch.Tensor, H: int, C: int = 2048,
                seed: int = 1):
    """The pool rows' inputs, the same for every image of ``proposals``
    (B, P, 4): a random (H/8, H/8, C) bf16 map drawn from ``seed`` (the
    tool's own map), the first image's proposals and a roi_scale of ones,
    each repeated over the batch. Returns (features, boxes, roi_scale)."""
    B, P, _ = proposals.shape
    dev = proposals.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    Hf = H // 8
    feats = torch.randn(Hf, Hf, C, device=dev, generator=gen).to(
        torch.bfloat16)
    return (feats.expand(B, Hf, Hf, C).contiguous(),
            proposals[0].expand(B, P, 4).contiguous(),
            torch.ones(B, P, device=dev))


def run(iters: int = 10, device=None, B: int = 2, H: int = 704,
        P: int = 4096, cfg_file: str = FLAGSHIP, overrides=(),
        timer: Callable[[Callable[[], object], int], float] = cuda_ms,
        emit: Optional[Callable[[Row], None]] = None) -> List[Row]:
    """Time every part; returns the rows in order and hands each to
    ``emit`` as it is measured. ``device`` is CUDA unless the caller names
    another; ``timer(fn, iters)`` returns ms per call and makes one warm-up
    call plus ``iters`` calls."""
    import drn_wsod_torch
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.engine.trainer import step_generator
    from drn_wsod_torch.ops.roi_pool import roi_pool_batched, roi_pool_looped

    dev = resolve_device(device)
    rows: List[Row] = []

    def add(row: Row) -> float:
        rows.append(row)
        if emit is not None:
            emit(row)
        return row.ms

    def measure(name, fn, n=iters):
        return add(Row(name, timer(fn, n), n + 1))

    cfg = flagship_cfg(cfg_file, overrides)
    C_cls = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    gen = torch.Generator(device=dev).manual_seed(0)
    model = drn_wsod_torch.build_model(cfg, device=dev, generator=gen)
    batch = drn_wsod_torch.synthetic_batch(B, H, H, P, C_cls, seed=0,
                                           device=dev)
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)

    # ---- full step
    step = drn_wsod_torch.make_train_step(model, tx)
    measure(f"full train step (B={B})", lambda: step(state, batch, 0))

    # ---- forward-only loss
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    drop = step_generator(0, 0, dev)

    def loss():
        losses = model(batch, train=True, generator=drop)
        return sum(losses[k] for k in sorted(losses))

    def fwd_loss():
        with torch.no_grad():
            return loss()

    measure("forward loss only", fwd_loss)

    # ---- forward + backward (no optimizer)
    measure("forward+backward (no opt)",
            lambda: torch.autograd.grad(loss(), list(params.values()),
                                        allow_unused=True))

    # ---- inference scores
    measure("inference_scores fwd", lambda: model.inference_scores(batch))

    # ---- K steps back to back
    K = 10
    stacked = drn_wsod_torch.WSODBatch(**{
        f.name: torch.stack([getattr(batch, f.name)] * K)
        for f in dataclasses.fields(batch)})
    multi = drn_wsod_torch.make_multi_train_step(step)
    ms = measure(f"{K} steps back to back (total)",
                 lambda: multi(state, stacked, 0), n=max(iters // 5, 1))
    add(Row("  -> per step", ms / K, 0))
    del stacked

    # ---- the pool kernels alone, at the tool's own map
    C = 2048
    feats_b, boxes_b, scale_b = pool_inputs(batch.proposals, H, C)
    measure(f"K1 pool, batched kernel (B={B})",
            lambda: roi_pool_batched(feats_b, boxes_b, 0.125, 7, scale_b))
    measure(f"K2 pool, looped per image (B={B})",
            lambda: roi_pool_looped(feats_b, boxes_b, 0.125, 7, scale_b))
    measure(f"K2 pool, looped per image, int8 (B={B})",
            lambda: roi_pool_looped(feats_b, boxes_b, 0.125, 7, scale_b,
                                    quantize_int8=True))
    del feats_b

    # ---- fc1 alone
    D = cfg.MODEL.ROI_BOX_HEAD.DAN_DIM[0]
    x = torch.randn(B * P, 49 * C, device=dev, generator=gen,
                    dtype=torch.bfloat16)
    w = torch.randn(49 * C, D, device=dev, generator=gen,
                    dtype=torch.bfloat16)
    measure("FC1 fwd alone", lambda: x @ w)
    dy = torch.randn(B * P, D, device=dev, generator=gen,
                     dtype=torch.bfloat16)
    measure("FC1 wgrad alone", lambda: x.T @ dy)
    del x, w, dy

    # ---- optimizer alone (before the WSDDN model, so the OICR state can
    # be freed first)
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    measure("optimizer update alone",
            lambda: tx.update(zeros, state.opt_state, params))
    del model, state, tx, params, zeros, step, multi
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # ---- WSDDN-only variant (no refinement branches)
    cfg2 = flagship_cfg(cfg_file, tuple(overrides)
                        + ("MODEL.ROI_HEADS.NAME", "WSDDNROIHeads"))
    model2 = drn_wsod_torch.build_model(cfg2, device=dev, generator=gen)
    tx2 = drn_wsod_torch.build_optimizer(cfg2, model2)
    state2 = drn_wsod_torch.create_train_state(model2, tx2)
    step2 = drn_wsod_torch.make_train_step(model2, tx2)
    measure("train step WSDDN-only (no OICR)",
            lambda: step2(state2, batch, 0))
    return rows


def format_row(row: Row, tag: str) -> str:
    return f"{row.name:55s} {row.ms:8.3f} ms {tag}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10,
                    help="timed calls per part, after one warm-up call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_bench: no CUDA device; the timings are of the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"[{card()}]"
    run(args.iters, emit=lambda r: print(format_row(r, tag), flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
