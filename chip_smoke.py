#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA device and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the package from its sources (nvcc);
  3. each kernel against its plain PyTorch version at the flagship shape
     (RoIPool: B=2, 87x87x2048 bf16 map, P=4096 RoIs with edge cases and
     invalid slots), max |diff| must be 0; kernel, plain and bound times;
  4. the detect path of the flagship config at full width (R50-WS DC5,
     DAN [2048, 4096], 3 OICR branches, bf16, seeded random weights),
     answering detect requests of B=2 704x704 images with P=4096 proposals,
     with every kernel's launch count read around that run. Requests are
     timed in windows, one client, each request read back before the next
     is sent: the host clock and CUDA events over each request and over the
     whole window. Then a per-part split of a few more requests (device ms
     and the host ms taken to issue each part), with the card's clocks
     sampled throughout;
  5. the CUDA tests (``tests/test_torch_cuda.py``: each kernel against its
     plain version at a small shape, and a toy config on the card against
     the same weights on the CPU), run by pytest; every test must pass.
The second-to-last line is a JSON object of per-kernel numbers, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

FLAGSHIP = "configs/PascalVOC-Detection/oicr_WSR_50_DC5_1x.yaml"
B, IMG, P = 2, 704, 4096
WARMUP, REQUESTS, WINDOWS, SPLITS = 2, 5, 3, 5
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 ops/s
# outside the tensor cores
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class ClockSampler:
    """The card's SM and memory clocks, power draw and temperature, read by
    ``nvidia-smi`` every 50 ms while the context is open."""

    FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={','.join(self.FIELDS)}",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out = self.proc.communicate(timeout=10)[0]
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        self.summary = "no samples" if not rows else ", ".join(
            f"{name} min {min(col):g} median {statistics.median(col):g} "
            f"max {max(col):g}"
            for name, col in zip(self.FIELDS, zip(*rows))) + \
            f" ({len(rows)} samples)"


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pool_inputs(dev, generator):
    """Flagship-shaped RoIPool inputs: the synthetic-batch box distribution
    at 704 px with edge cases mixed in, and some invalid slots."""
    from drn_wsod_torch.synthetic import synthetic_batch

    batch = synthetic_batch(B, IMG, IMG, P, 20, seed=1, device="cpu")
    boxes = batch.proposals.numpy().copy()
    rng = np.random.RandomState(2)
    n = 64
    boxes[:, 0:n] = 8.0 * (rng.randint(-3, 90, (B, n, 4)) + 0.5)  # half cells
    boxes[:, n:2 * n, 2:] = boxes[:, n:2 * n, :2] - rng.uniform(
        0, 40, (B, n, 2))                                      # x2<x1, y2<y1
    boxes[:, 2 * n:3 * n] += rng.uniform(-900, 900, (B, n, 1))  # off the map
    boxes[:, 3 * n] = [-50, -50, IMG + 50, IMG + 50]           # whole map
    boxes[:, 3 * n + 1] = [100, 100, 101, 101]                 # sub-cell
    obj = batch.objectness.numpy()
    mask = rng.uniform(0, 1, (B, P)) > 0.05
    mask[:, -256:] = False                                     # padded tail
    scale = ((obj + 1.0) * mask).astype(np.float32)
    feats = torch.randn(B, 87, 87, 2048, device=dev, generator=generator,
                        dtype=torch.float32).to(torch.bfloat16)
    return (feats, torch.from_numpy(boxes).to(dev),
            torch.from_numpy(scale).to(dev))


def roi_pool_bound(feats, boxes, scale, out, spatial_scale: float):
    """Least time for this call: bytes moved once (map, boxes, scales read;
    output written) over HBM rate, against this data's max comparisons
    (cells of every bin times channels) plus the epilogue multiplies over
    the float32 rate. Returns (ms, "bytes" | "operations")."""
    from drn_wsod_torch.ops.roi_pool import bin_edges, map_coords

    _, H, W, C = feats.shape
    x1, y1, rw, rh = map_coords(boxes.reshape(-1, 4), spatial_scale)
    ylo, yhi = bin_edges(y1, rh, H, 7)
    xlo, xhi = bin_edges(x1, rw, W, 7)
    cells = ((yhi - ylo).clamp(min=0)[:, :, None]
             * (xhi - xlo).clamp(min=0)[:, None, :]).sum().item()
    ops = cells * C + out.numel()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (feats, boxes, scale, out))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def timed_window(detect, batches):
    """Closed loop, one client: each request is read back (synchronised)
    before the next is sent. Returns the outputs, per-request host ms and
    device ms (CUDA events around each request), and the window's host ms
    and device ms (first request's start to last request's end)."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in batches]
    ends = [torch.cuda.Event(enable_timing=True) for _ in batches]
    outs, host = [], []
    t_window = time.perf_counter()
    for batch, start, end in zip(batches, starts, ends):
        t = time.perf_counter()
        start.record()
        outs.append(detect(batch))
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    window_host = (time.perf_counter() - t_window) * 1e3
    device = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    return outs, host, device, window_host, starts[0].elapsed_time(ends[-1])


def split_request(model, detect, batch):
    """Time of each part of one request, from marks set by hooks on the
    model's own modules: device ms between CUDA events, and host ms the
    Python thread took to issue the part (launches are asynchronous, so
    where a part's host ms reaches its device ms the card waits on the
    host). Returns (device, host), each {part: ms}."""
    marks, issued = {}, {}

    def mark(name):
        def hook(*_):
            issued[name] = time.perf_counter()
            marks[name] = torch.cuda.Event(enable_timing=True)
            marks[name].record()
        return hook

    hooks = [model.backbone.register_forward_pre_hook(mark("backbone_in")),
             model.backbone.register_forward_hook(mark("backbone_out")),
             model.box_head.fc1.register_forward_pre_hook(mark("fc1_in")),
             model.box_head.fc1.register_forward_hook(mark("fc1_out")),
             model.box_head.register_forward_hook(mark("dan_out"))]
    scores_fn = model.inference_scores

    def timed_scores(b):
        out = scores_fn(b)
        mark("scores_out")()
        return out

    model.inference_scores = timed_scores
    try:
        mark("request_in")()
        detect(batch)
        mark("request_out")()
        torch.cuda.synchronize()
    finally:
        del model.inference_scores
        for h in hooks:
            h.remove()
    order = ["request_in", "backbone_in", "backbone_out", "fc1_in", "fc1_out",
             "dan_out", "scores_out", "request_out"]
    names = ["preprocess", "backbone", "pool kernel", "DAN fc1", "DAN fc2",
             "heads", "NMS + rescale"]
    spans = list(zip(names, order, order[1:]))
    return ({n: marks[a].elapsed_time(marks[b]) for n, a, b in spans},
            {n: (issued[b] - issued[a]) * 1e3 for n, a, b in spans})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    card_line = card()
    tag = f"[{card_line}]"
    print(f"phase 1: card {card_line}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    # the port's float32 paths run in full float32; the flagship runs bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import drn_wsod_torch
    from drn_wsod_torch.ops import _build
    from drn_wsod_torch.ops import roi_pool as rp

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase 2: built {sorted(logs)} in {time.perf_counter() - t0:.2f} s "
          f"{tag}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # ---- phase 3: every kernel against its plain version, flagship shape
    feats, boxes, scale = pool_inputs(dev, gen)
    got = rp.roi_pool_batched(feats, boxes, 0.125, 7, scale)
    torch.cuda.synchronize()
    want = rp.roi_pool_plain(feats, boxes, 0.125, 7, scale)
    err = (got.float() - want.float()).abs().max().item()
    if err != 0.0 or not torch.isfinite(got.float()).all():
        print(f"phase 3: FAIL roi_pool kernel vs plain max|diff| {err}")
        return 1
    del want
    kernel_ms = cuda_ms(lambda: rp.roi_pool_batched(feats, boxes, 0.125, 7,
                                                    scale), 20)
    plain_ms = cuda_ms(lambda: rp.roi_pool_plain(feats, boxes, 0.125, 7,
                                                 scale), 5)
    bound_ms, bound_by = roi_pool_bound(feats, boxes, scale, got, 0.125)
    print(f"phase 3: roi_pool kernel == plain (max|diff| 0.0) at "
          f"{tuple(feats.shape)} bf16, P={P}: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"no single PyTorch call computes RoIPool (no torchvision), "
          f"library n/a {tag}", flush=True)
    del feats, boxes, scale, got

    # ---- phase 4: the detect path at full flagship width
    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(FLAGSHIP)
    cfg.TEST.AUG.ENABLED = False          # TTA is a later slice of the port
    model = drn_wsod_torch.build_model(cfg, device=dev, generator=gen)
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    detect = drn_wsod_torch.make_detect_fn(
        model, cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST, topk, device=dev)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    batches = [drn_wsod_torch.synthetic_batch(B, IMG, IMG, P, C, seed=s,
                                              device=dev)
               for s in range(WARMUP + REQUESTS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rp.roi_pool_batched.launches = 0
    with ClockSampler() as clock_sampler:
        outs = [detect(batch) for batch in batches[:WARMUP]]
        torch.cuda.synchronize()
        windows = []
        for _ in range(WINDOWS):
            w = timed_window(detect, batches[WARMUP:])
            outs += w[0]
            windows.append(w[1:])
        launches = {"roi_pool": rp.roi_pool_batched.launches}
        # the per-part split runs after the count is read: its hooks make
        # these requests differ from a caller's
        parts = [split_request(model, detect,
                               batches[WARMUP + i % REQUESTS])
                 for i in range(SPLITS)]

    n_req = WARMUP + WINDOWS * REQUESTS
    if launches["roi_pool"] != n_req:
        print(f"phase 4: FAIL roi_pool launched {launches['roi_pool']} times "
              f"for {n_req} requests")
        return 1
    for dets in outs:
        shapes = {k: tuple(v.shape) for k, v in dets.items()}
        want_shapes = {"boxes": (B, topk, 4), "scores": (B, topk),
                       "classes": (B, topk), "valid": (B, topk),
                       "all_scores": (B, P, C + 1), "all_boxes": (B, P, 4)}
        if shapes != want_shapes:
            print(f"phase 4: FAIL output shapes {shapes}")
            return 1
        finite = all(torch.isfinite(v.float()).all().item()
                     for v in dets.values())
        row_sums = dets["all_scores"].sum(-1)
        if (not finite or not dets["valid"].any()
                or (row_sums - 1).abs().max().item() > 1e-4
                or (dets["scores"] < 0).any() or (dets["scores"] > 1).any()
                or (dets["classes"][dets["valid"]] >= C).any()):
            print("phase 4: FAIL outputs not finite, empty or out of range")
            return 1
    print(f"phase 4: {n_req} detect requests (B={B}, {IMG}x{IMG}, P={P}, "
          f"R50-WS DC5, DAN [2048, 4096], 3 OICR branches, bf16); "
          f"roi_pool launches {launches['roi_pool']} (one per request); "
          f"outputs finite, shapes {shapes}", flush=True)
    for i, (host, device, window_host, window_dev) in enumerate(windows):
        print(f"phase 4: window {i} of {REQUESTS} requests: "
              f"{B * REQUESTS / window_dev * 1e3:.3f} img/s by CUDA events "
              f"({window_dev:.3f} ms), "
              f"{B * REQUESTS / window_host * 1e3:.3f} img/s by the host "
              f"clock ({window_host:.3f} ms); request ms device "
              f"[{', '.join(f'{t:.3f}' for t in device)}], host "
              f"[{', '.join(f'{t:.3f}' for t in host)}] {tag}", flush=True)
    print(f"phase 4: peak device memory of the requests "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}",
          flush=True)
    for what, runs in (("device", [d for d, _ in parts]),
                       ("host issue", [h for _, h in parts])):
        split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        print(f"phase 4: {what} ms per part, median of {SPLITS} requests "
              "with hooks: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + "; sum per request ["
              + ", ".join(f"{sum(r.values()):.3f}" for r in runs)
              + f"] {tag}", flush=True)
    print(f"phase 4: card during the requests: {clock_sampler.summary} "
          f"{tag}", flush=True)
    del model, detect, batches, outs
    torch.cuda.empty_cache()

    # ---- phase 5: the CUDA tests, small inputs against their references
    root = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py"],
        cwd=root, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(root)})
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or not re.fullmatch(
            r"=* *\d+ passed(, \d+ warnings?)? in .*", summary):
        print(f"phase 5: FAIL tests/test_torch_cuda.py: {summary}\n"
              f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
        return 1
    print(f"phase 5: tests/test_torch_cuda.py on the card: {summary} {tag}",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "roi_pool", "route": "cuda",
        "source": "drn_wsod_torch/ops/csrc/roi_pool.cu",
        "replaces": "drn_wsod_tpu/ops/roi_pool_pallas.py:695",
        "launches": launches["roi_pool"], "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
