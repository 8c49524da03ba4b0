#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA device and the
CUDA toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel of the package from its sources (nvcc, one
     process per source, in parallel), timed, with each kernel's registers,
     spills and shared memory (``-Xptxas -v``);
  3. each kernel against its plain PyTorch version at the shape its path
     gives it, max |diff| must be 0; kernel, plain and bound times. K1
     (batched RoIPool): B=2, 87x87x2048 bf16 maps, P=4096 RoIs with edge
     cases and invalid slots, as the detect and train paths give it, with
     its cell reads (each RoI cell once, and bin by bin), its read rate,
     and its time with the RoIs in RoI order beside the top-row order the
     wrapper launches them in; K2
     (single-image RoIPool, float and int8 mode) looped over the ablation
     tool's own B=2 88x88x2048 bf16 inputs, and on the edge-case boxes of
     the first 87x87 image; K3 (banded RoIPool) against its plain version
     and against K1 on the banded probe's own inputs at its four buckets
     (B=1, P=4096, 88^2 to 192^2 x 2048 bf16), with its time split into the
     partition, the band launch (beside its own bound), the top-row order
     and the rest launch, and on the edge-case boxes of K1's inputs; K2's
     time split into one image's quantization, its top-row order, one
     launch (in the top-row order and in RoI order) and the looped call
     beside K1's B=2 call, each queued alone, and the looped call's peak
     memory against its output plus one image's quantization; K4
     (narrow-dtype max) bit for bit in each of its six
     dtypes, on the dtype probe's input and on seeded random bit patterns,
     with ``torch.maximum`` of the halves timed beside it where torch has it,
     and the wrapper's host issue split into its parts;
  4. the detect path of the flagship config at full width (R50-WS DC5,
     DAN [2048, 4096], 3 OICR branches, bf16, seeded random weights),
     answering detect requests of B=2 704x704 images with P=4096 proposals.
     Requests are timed in windows, one client, each request read back
     before the next is sent: the host clock and CUDA events over each
     request and over the whole window. Then a per-part split of a few more
     requests (device ms and the host ms taken to issue each part), with the
     card's clocks sampled throughout;
  5. the train step of the flagship config at full width (the YAML's
     solver, dropout 0.5, bf16, B=2, 704x704, P=4096): warm-up steps, then
     windows of steps timed by CUDA events and the host clock; every loss
     finite under the JAX package's names, frozen parameters bit-unchanged,
     trainable ones moved, one K1 launch per step, peak memory, and a
     per-part split of a few more steps;
  6. the port's train-step ablation tool (``drn_wsod_torch.tools.
     ablate_bench``) at its full shape: every line of its table, with K2
     launched B times per looped call in each mode;
  7. the port's banded-pool probe (``drn_wsod_torch.tools.
     pool_banded_probe``) at its four buckets: classic (K1) against banded
     (K3) device ms, max |diff| 0, one K1 launch per classic call and one
     launch of each of K3's two kernels per banded call;
  8. the port's dtype probe (``drn_wsod_torch.tools.mosaic_dtype_probe``):
     every dtype OK, one K4 launch each;
  9. the CUDA tests (``tests/test_torch_cuda.py``: each kernel against its
     plain version at a small shape, and toy configs on the card against the
     same weights on the CPU), run by pytest; every test must pass;
 10. the flagship's eval protocol ("eval"): ``GeneralizedRCNNWithTTAAVG.
     detect_image`` at full width with the YAML's TTA (8 scales x flip,
     MAX_SIZE 4000, views built on the device), P=4096 VOC-like proposals,
     on 2 warm-up and 8 timed VOC07-sized u8 images drawn from a seed (the
     JPEG decode is the one step left out): ms per image by CUDA events and
     the host clock, views and bucket groups per image, one K1 launch per
     group, a per-part split of each timed image, peak memory, K1 against
     its plain version on the largest group's own inputs (B=4, the 1216
     bucket's 2048-channel bf16 maps), detections finite and inside their
     images, and the VOC evaluator's AP and CorLoc finite in [0, 100].
Every path (4-8, 10) is run with the kernels' launch counts set to 0 just
before it and read just after. The second-to-last line is the card's name
and power limit, the line before it a JSON object of per-kernel numbers,
the last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B, IMG, P = 2, 704, 4096
WARMUP, REQUESTS, WINDOWS, SPLITS = 2, 5, 3, 5
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_WINDOWS, TRAIN_SPLITS = 2, 5, 3, 3
ABLATE_ITERS = 3
PROBE_ITERS = 10
# the eval phase's VOC07-test-like images, (H, W): 500x375, 375x500,
# 500x333, 333x500, 500x500, 486x500, 500x281 and 400x500 (W x H); the two
# warm-up images take the first two sizes
EVAL_SIZES = ((375, 500), (500, 375), (333, 500), (500, 333), (500, 500),
              (500, 486), (281, 500), (500, 400))
EVAL_WARMUP = 2
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 ops/s
# outside the tensor cores
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12


class Fail(Exception):
    """A phase failed; the message says which and why."""


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


def queued_ms(fn, calls: int) -> float:
    """Device ms per call of ``fn`` with its host issue hidden: after a
    warm-up call, ``calls`` calls are queued behind a sleep of about 50 ms
    on the stream, so the card runs them back to back; CUDA events around
    the calls. For work that takes the host about as long to issue as the
    card to run (K3's partition, K4's tiny launches)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fn, calls: int) -> float:
    """Host us per call to issue ``fn``, ``time.perf_counter`` over
    ``calls`` calls issued with the card idle (few enough that the launch
    queue never fills, so the host never waits on the card)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def identity_order(boxes):
    """(B, P) int32 0..P-1 in each row on the boxes' device: K1's launch
    with its blocks taking the RoIs in RoI order."""
    B, P = boxes.shape[:2]
    return torch.arange(P, dtype=torch.int32,
                        device=boxes.device).expand(B, P).contiguous()


def ptxas_report(log: str):
    """(kernel, [ptxas lines]) for each kernel of one source's build log:
    its registers, spills and stack; names demangled by the toolkit's
    ``cu++filt`` where it has one."""
    from drn_wsod_torch.ops import _build

    entries, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = entries.setdefault(m.group(1), [])
        elif cur is not None and ("registers" in line or "spill" in line):
            cur.append(line.split("ptxas info    :")[-1].strip())
    names = list(entries)
    try:
        tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
        out = subprocess.run([tool, *names], capture_output=True, text=True,
                             timeout=60, check=True).stdout.splitlines()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        out = names
    if len(out) != len(names):
        out = names
    return [(_without_params(label), entries[n])
            for label, n in zip(out, names)]


def _without_params(label: str) -> str:
    """A demangled kernel name without ``void`` and its parameter list
    (the last parenthesised group; template arguments such as ``(int)7``
    stay)."""
    label = label.removeprefix("void ")
    depth = 0
    for i in range(len(label) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(label[i], 0)
        if depth == 0:
            return label[:i] if label.endswith(")") else label
    return label


def pool_boxes():
    """The flagship RoIPool inputs' boxes (B, P, 4) and roi_scale (B, P),
    on the CPU: the synthetic-batch box distribution at 704 px with edge
    cases mixed in, and some invalid slots."""
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
    return torch.from_numpy(boxes), torch.from_numpy(scale)


def pool_inputs(dev, generator):
    """Flagship-shaped RoIPool inputs: random (B, 87, 87, 2048) bf16 maps
    and :func:`pool_boxes`, on ``dev``."""
    boxes, scale = pool_boxes()
    feats = torch.randn(B, 87, 87, 2048, device=dev, generator=generator,
                        dtype=torch.float32).to(torch.bfloat16)
    return feats, boxes.to(dev), scale.to(dev)


def roi_pool_bound(feats, boxes, scale, out, spatial_scale: float,
                   epilogue_ops: int = 1):
    """Least time for this call: bytes moved once (map, boxes, scales read;
    output written) over HBM rate, against this data's max comparisons
    (cells of every bin times channels) plus ``epilogue_ops`` multiplies per
    output over the float32 rate. Returns (ms, "bytes" | "operations")."""
    from drn_wsod_torch.ops.roi_pool import bin_cells

    H, W, C = feats.shape[-3:]
    cells = bin_cells(boxes, spatial_scale, H, W).sum().item()
    ops = cells * C + epilogue_ops * out.numel()
    nbytes = sum(t.numel() * t.element_size()
                 for t in (feats, boxes, scale, out))
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _launch_counts():
    """The wrappers' per-kernel launch counters (dicts)."""
    from drn_wsod_torch.ops import narrow_max as nm
    from drn_wsod_torch.ops import roi_pool as rp

    return (rp.roi_pool_image.launches, rp.roi_pool_banded.launches,
            nm.narrow_max.launches)


def reset_launches():
    from drn_wsod_torch.ops import roi_pool as rp

    rp.roi_pool_batched.launches = 0
    for counts in _launch_counts():
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    from drn_wsod_torch.ops import roi_pool as rp

    image, banded, narrow = _launch_counts()
    return {"roi_pool": rp.roi_pool_batched.launches, **image, **banded,
            **{f"narrow_max_{k}": v for k, v in narrow.items()}}


class Marks:
    """CUDA events and host times at named points in the order they are
    reached, set by hooks on the model's own modules; ``split`` sums each
    span between consecutive points into the part its starting point opens
    (a point reached once per TTA bucket group adds the groups' spans):
    per-part device ms and host-issue ms (launches are asynchronous, so
    where a part's host ms reaches its device ms the card waits on the
    host)."""

    def __init__(self):
        self.marks, self.hooks = [], []

    def __call__(self, name):
        def mark(*_):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((name, event, time.perf_counter()))
        return mark

    def hook(self, module, before: str, after: str):
        self.hooks += [module.register_forward_pre_hook(self(before)),
                       module.register_forward_hook(self(after))]

    def remove(self):
        for h in self.hooks:
            h.remove()

    def split(self, parts: dict):
        """``parts`` maps each point but the last to the part it opens."""
        device = dict.fromkeys(parts.values(), 0.0)
        host = dict.fromkeys(parts.values(), 0.0)
        for (a, ea, ha), (_, eb, hb) in zip(self.marks, self.marks[1:]):
            device[parts[a]] += ea.elapsed_time(eb)
            host[parts[a]] += (hb - ha) * 1e3
        return device, host


def timed_window(run, inputs):
    """Closed loop, one client: each call is read back (synchronised)
    before the next is sent. Returns the outputs, per-call host ms and
    device ms (CUDA events around each call), and the window's host ms and
    device ms (first call's start to last call's end)."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in inputs]
    ends = [torch.cuda.Event(enable_timing=True) for _ in inputs]
    outs, host = [], []
    t_window = time.perf_counter()
    for x, start, end in zip(inputs, starts, ends):
        t = time.perf_counter()
        start.record()
        outs.append(run(x))
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    window_host = (time.perf_counter() - t_window) * 1e3
    device = [a.elapsed_time(b) for a, b in zip(starts, ends)]
    return outs, host, device, window_host, starts[0].elapsed_time(ends[-1])


def print_windows(phase, what, n, windows, tag):
    for i, (host, device, window_host, window_dev) in enumerate(windows):
        print(f"{phase}: window {i} of {n} {what}: "
              f"{B * n / window_dev * 1e3:.3f} img/s by CUDA events "
              f"({window_dev:.3f} ms), "
              f"{B * n / window_host * 1e3:.3f} img/s by the host "
              f"clock ({window_host:.3f} ms); ms each, device "
              f"[{', '.join(f'{t:.3f}' for t in device)}], host "
              f"[{', '.join(f'{t:.3f}' for t in host)}] {tag}", flush=True)


def print_split(phase, what, parts, tag):
    for kind, runs in (("device", [d for d, _ in parts]),
                       ("host issue", [h for _, h in parts])):
        split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        print(f"{phase}: {kind} ms per part, median of {len(runs)} {what} "
              "with hooks: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + "; sum each ["
              + ", ".join(f"{sum(r.values()):.3f}" for r in runs)
              + f"] {tag}", flush=True)


def split_request(model, detect, batch):
    """Per-part device and host-issue ms of one detect request."""
    marks = Marks()
    marks.hook(model.backbone, "backbone_in", "backbone_out")
    marks.hook(model.box_head.fc1, "fc1_in", "fc1_out")
    marks.hooks.append(model.box_head.register_forward_hook(marks("dan_out")))
    scores_fn = model.inference_scores

    def timed_scores(b):
        out = scores_fn(b)
        marks("scores_out")()
        return out

    model.inference_scores = timed_scores
    try:
        marks("request_in")()
        detect(batch)
        marks("request_out")()
        torch.cuda.synchronize()
    finally:
        del model.inference_scores
        marks.remove()
    return marks.split({
        "request_in": "preprocess", "backbone_in": "backbone",
        "backbone_out": "pool kernel", "fc1_in": "DAN fc1",
        "fc1_out": "DAN fc2", "dan_out": "heads",
        "scores_out": "NMS + rescale"})


def split_step(model, tx, step, state, batch):
    """Per-part device and host-issue ms of one train step."""
    marks = Marks()
    marks.hook(model, "forward_in", "forward_out")
    marks.hook(model.backbone, "backbone_in", "backbone_out")
    marks.hook(model.box_head, "dan_in", "dan_out")
    update = tx.update

    def timed_update(*args):
        marks("update_in")()
        update(*args)
        marks("update_out")()

    tx.update = timed_update
    try:
        marks("step_in")()
        step(state, batch, 0)
        torch.cuda.synchronize()
    finally:
        del tx.update
        marks.remove()
    return marks.split({
        "step_in": "set-up", "forward_in": "preprocess",
        "backbone_in": "backbone", "backbone_out": "pool kernel",
        "dan_in": "DAN forward", "dan_out": "heads and losses",
        "forward_out": "backward", "update_in": "optimizer"})


def split_tta(model, tta, image, record):
    """Per-part device and host-issue ms of one TTA image, summed over its
    bucket groups: set-up (the uploads), view build (the device views and
    preprocess), backbone, K1 (with the map's layout and the RoI scales),
    DAN, heads (with the sums over views), finalize with NMS (and the host
    copy of the detections)."""
    from drn_wsod_torch import tta as tta_mod

    marks = Marks()
    marks.hook(model.backbone, "backbone_in", "backbone_out")
    marks.hook(model.box_head, "dan_in", "dan_out")
    build, finalize = tta_mod._device_view_batch, tta._finalize

    def timed_build(*args):
        marks("view_in")()
        return build(*args)

    def timed_finalize(*args):
        marks("finalize_in")()
        return finalize(*args)

    tta_mod._device_view_batch, tta._finalize = timed_build, timed_finalize
    try:
        marks("request_in")()
        tta.detect_image(image, record)
        marks("request_out")()
        torch.cuda.synchronize()
    finally:
        tta_mod._device_view_batch, tta._finalize = build, finalize
        marks.remove()
    return marks.split({
        "request_in": "set-up", "view_in": "view build",
        "backbone_in": "backbone", "backbone_out": "K1", "dan_in": "DAN",
        "dan_out": "heads", "finalize_in": "finalize + NMS"})


def exact(name, got, want, phase: int = 3) -> float:
    """max |got - want|; raises unless it is 0 and ``got`` is finite."""
    err = (got.float() - want.float()).abs().max().item()
    if err != 0.0 or not torch.isfinite(got.float()).all():
        raise Fail(f"phase {phase}: {name} kernel vs plain max|diff| {err}")
    return err


def kernel_entry(name, source, replaces, err, ms, plain_ms, bound,
                 library_ms=None) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


# ---------------------------------------------------------------- phases
def phase3_kernels(dev, gen, tag) -> dict:
    """Every kernel against its plain version at the shape its path gives
    it: K1 at the detect and train paths' flagship shape, K2 in both modes
    on the very inputs the ablation tool (phase 6) pools, built by the
    tool's own ``pool_inputs``. K2 is also held on the flagship edge-case
    boxes of one 87x87 image."""
    from drn_wsod_torch.ops import roi_pool as rp
    from drn_wsod_torch.synthetic import synthetic_batch
    from drn_wsod_torch.tools import ablate_bench

    feats, boxes, scale = pool_inputs(dev, gen)
    f0, b0, s0 = feats[0], boxes[0], scale[0]
    edge_err = {}
    for name, int8 in (("roi_pool_image", False),
                       ("roi_pool_image_int8", True)):
        edge_err[name] = exact(
            name, rp.roi_pool_image(f0, b0, 0.125, 7, s0, int8),
            rp.roi_pool_image_plain(f0, b0, 0.125, 7, s0, int8))
        print(f"phase 3: {name} kernel == plain (max|diff| 0.0) on the "
              f"edge-case boxes of one {tuple(f0.shape)} bf16 map, P={P}",
              flush=True)

    C_cls = ablate_bench.flagship_cfg().MODEL.ROI_HEADS.NUM_CLASSES
    tf, tb, ts = ablate_bench.pool_inputs(
        synthetic_batch(B, IMG, IMG, P, C_cls, seed=0, device=dev).proposals,
        IMG)

    def looped_plain(int8):
        return torch.stack([rp.roi_pool_image_plain(f, b, 0.125, 7, s, int8)
                            for f, b, s in zip(tf, tb, ts)])

    cases = {
        "roi_pool": (
            "drn_wsod_torch/ops/csrc/roi_pool.cu",
            "drn_wsod_tpu/ops/roi_pool_pallas.py:695",
            lambda: rp.roi_pool_batched(feats, boxes, 0.125, 7, scale),
            lambda: rp.roi_pool_plain(feats, boxes, 0.125, 7, scale),
            (feats, boxes, scale), 1, "one call, the detect and train "
            "paths' flagship inputs"),
        "roi_pool_image": (
            "drn_wsod_torch/ops/csrc/roi_pool_image.cu",
            "drn_wsod_tpu/ops/roi_pool_pallas.py:1030",
            lambda: rp.roi_pool_looped(tf, tb, 0.125, 7, ts),
            lambda: looped_plain(False),
            (tf, tb, ts), 1, f"one roi_pool_looped call ({B} launches), "
            "the ablation tool's inputs"),
        "roi_pool_image_int8": (
            "drn_wsod_torch/ops/csrc/roi_pool_image.cu",
            "drn_wsod_tpu/ops/roi_pool_pallas.py:1030 (quantize_int8, "
            ":1097-1108)",
            lambda: rp.roi_pool_looped(tf, tb, 0.125, 7, ts, True),
            lambda: looped_plain(True),
            (tf, tb, ts), 2, f"one roi_pool_looped call ({B} launches), "
            "the ablation tool's inputs"),
    }
    kernels = {}
    for name, (source, replaces, kernel, plain, args, epi,
               what) in cases.items():
        got = kernel()
        torch.cuda.synchronize()
        err = max(exact(name, got, plain()), edge_err.get(name, 0.0))
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 5)
        bound_ms, bound_by = roi_pool_bound(*args, got, 0.125, epi)
        print(f"phase 3: {name} kernel == plain (max|diff| 0.0) at "
              f"{tuple(args[0].shape)} bf16, P={P}, {what}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}); no single PyTorch call computes RoIPool (no "
              f"torchvision), library n/a {tag}", flush=True)
        kernels[name] = kernel_entry(name, source, replaces, err, ms,
                                     plain_ms, (bound_ms, bound_by))
        del got
    phase3_k1_reads(feats, boxes, scale, kernels["roi_pool"]["ms"], tag)
    phase3_k2_split(tf, tb, ts, tag)
    kernels["roi_pool_banded"] = phase3_banded(feats, boxes, scale, tag)
    del feats, tf
    kernels.update(phase3_narrow_max(dev, tag))
    return kernels


def cell_reads_gb(feats, boxes):
    """K1's cell reads per call, GB: each RoI's clamped cells once
    (``roi_cells``, what its body reads) and every bin's cells
    (``bin_cells``, what a pool that reads each bin separately reads)."""
    from drn_wsod_torch.ops import roi_pool as rp

    H, W, C = feats.shape[-3:]
    return tuple(count(boxes, 0.125, H, W).sum().item() * C
                 * feats.element_size() / 1e9
                 for count in (rp.roi_cells, rp.bin_cells))


def phase3_k1_reads(feats, boxes, scale, ms, tag) -> None:
    """K1 at the flagship shape: its cell reads and read rate, its time
    queued (calls back to back, the host's issue hidden) beside phase 3's
    single call ``ms``, and the same launch with the RoIs in RoI order
    instead of the top-row order (``top_row_order``, timed alone too):
    exact either way."""
    from drn_wsod_torch.ops import roi_pool as rp

    def k1():
        return rp.roi_pool_batched(feats, boxes, 0.125, 7, scale)

    ident = identity_order(boxes)

    def roi_order():
        return rp._launch_batched(feats, boxes, 0.125, 7, scale, ident)

    exact("roi_pool in RoI order", roi_order(),
          rp.roi_pool_plain(feats, boxes, 0.125, 7, scale))
    queued, roi_order_queued = queued_ms(k1, 20), queued_ms(roi_order, 20)
    roi_order_ms = cuda_ms(roi_order, 20)
    sort_ms = queued_ms(lambda: rp.top_row_order(boxes), 20)
    sort_us, k1_us = (host_us(fn, 100) for fn in
                      (lambda: rp.top_row_order(boxes), k1))
    once, bins = cell_reads_gb(feats, boxes)
    print(f"phase 3: roi_pool cell reads per call {once:.2f} GB, each RoI "
          f"cell once (roi_cells; {bins:.2f} GB bin by bin, bin_cells): in "
          f"the top-row order {queued:.4f} ms queued ({once / queued:.2f} "
          f"GB/ms; a single call {ms:.4f} ms, the order alone {sort_ms:.4f} "
          f"ms queued); in RoI order {roi_order_queued:.4f} ms queued ("
          f"{once / roi_order_queued:.2f} GB/ms; a single call "
          f"{roi_order_ms:.4f} ms), exact; host issue, us per call over "
          f"100 calls: the order {sort_us:.3f} of the wrapper's "
          f"{k1_us:.3f} {tag}", flush=True)


def looped_peak_mb(fn) -> float:
    """MB allocated at the peak of one call of ``fn`` above what was
    allocated before it (its output included)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def phase3_k2_split(tf, tb, ts, tag) -> None:
    """K2's time on the ablation tool's inputs, each part queued alone:
    ``int8_quantize`` of one image, ``top_row_order`` of one image's boxes,
    one launch (in the top-row order the wrapper passes, and in RoI
    order), the whole ``roi_pool_looped`` call, and K1's B=2 call on the
    same inputs beside them; each launch exact against the plain version.
    Then the peak memory of one looped call, which must stay within 5% of
    its output plus one image's quantization."""
    from drn_wsod_torch.ops import roi_pool as rp

    f, b, s = tf[0], tb[0], ts[0]
    q, ch_scale = rp.int8_quantize(f)
    orders = {"top-row order": rp.top_row_order(b[None])[0],
              "RoI order": identity_order(b[None])[0]}
    out = torch.empty((b.shape[0], 7, 7, f.shape[2]), dtype=f.dtype,
                      device=f.device)
    k1_ms = queued_ms(lambda: rp.roi_pool_batched(tf, tb, 0.125, 7, ts), 20)
    order_ms = queued_ms(lambda: rp.top_row_order(b[None]), 20)
    for int8 in (False, True):
        name = "roi_pool_image_int8" if int8 else "roi_pool_image"
        want = rp.roi_pool_image_plain(f, b, 0.125, 7, s, int8)
        launches = {}
        for oname, order in orders.items():
            def launch():
                rp._launch_image(q if int8 else f, b, 0.125, 7, s, order, out,
                                 ch_scale if int8 else None)
            out.fill_(float("nan"))
            launch()
            exact(f"{name} one launch in {oname}", out, want)
            launches[oname] = queued_ms(launch, 20)

        def looped():
            return rp.roi_pool_looped(tf, tb, 0.125, 7, ts, int8)

        looped_ms = queued_ms(looped, 20)
        quant_ms = queued_ms(lambda: rp.int8_quantize(f), 20) if int8 else 0.0
        quant_mb = looped_peak_mb(lambda: rp.int8_quantize(f)) if int8 else 0.0
        out_mb = (tf.shape[0] * out.numel() * out.element_size()) / 1e6
        peak_mb = looped_peak_mb(looped)
        print(f"phase 3: {name} split, ms per call queued (20 calls behind a "
              f"sleep), the ablation tool's {tuple(tf.shape)} bf16 inputs, "
              f"P={b.shape[0]}: int8_quantize of one image "
              + (f"{quant_ms:.4f}" if int8 else "n/a")
              + f"; top_row_order of one image {order_ms:.4f}; one launch "
              "alone " + ", ".join(f"{k} {v:.4f}" for k, v in launches.items())
              + f"; the looped call (B={tf.shape[0]}, {tf.shape[0]} launches) "
              f"{looped_ms:.4f}; K1's B={tf.shape[0]} call on the same inputs "
              f"{k1_ms:.4f} (looped / K1 {looped_ms / k1_ms:.3f}) {tag}",
              flush=True)
        if peak_mb > 1.05 * (out_mb + quant_mb):
            raise Fail(f"phase 3: {name} looped peak {peak_mb:.1f} MB above "
                       f"its output {out_mb:.1f} MB and quantization "
                       f"{quant_mb:.1f} MB")
        print(f"phase 3: {name} peak memory of one looped call {peak_mb:.1f} "
              f"MB: the output {out_mb:.1f} MB, one image's quantization "
              f"{quant_mb:.1f} MB ({peak_mb / (out_mb + quant_mb):.3f}x their "
              f"sum) {tag}", flush=True)


def band_launch_bound(f, part, resolution=7, band_rows=48):
    """Least time of K3's band launch alone: the short RoIs' outputs
    written once and the staged bands (one per nonempty run, all channels)
    read once, at HBM rate. Returns (ms, output bytes, band bytes)."""
    H, W, C = f.shape[-3:]
    runs = (part.run_start.diff() > 0).sum().item()
    out_b = part.short.sum().item() * resolution ** 2 * C * f.element_size()
    band_b = runs * min(band_rows, H) * W * C * f.element_size()
    return (out_b + band_b) / PEAK_BYTES_S * 1e3, out_b, band_b


def phase3_banded(feats, boxes, scale, tag) -> dict:
    """K3 against its plain version and against K1: on K1's flagship
    edge-case inputs, then at each bucket of the banded probe on the
    probe's own inputs (its boxes drawn in its order), with K3's time split
    into its parts: the partition, the band launch (beside its own bound),
    the top-row order and the rest launch, each queued alone. Times at each
    bucket; the JSON entry holds the 1536 bucket's, the one K3 exists
    for."""
    from drn_wsod_torch.ops import roi_pool as rp
    from drn_wsod_torch.tools import pool_banded_probe

    got = rp.roi_pool_banded(feats, boxes, 0.125, 7, scale)
    torch.cuda.synchronize()
    err = max(exact("roi_pool_banded", got,
                    rp.roi_pool_banded_plain(feats, boxes, 0.125, 7, scale)),
              exact("roi_pool_banded (against K1)", got,
                    rp.roi_pool_batched(feats, boxes, 0.125, 7, scale)))
    del got
    print(f"phase 3: roi_pool_banded kernel == plain == roi_pool kernel "
          f"(max|diff| 0.0) on the edge-case boxes of {tuple(feats.shape)} "
          f"bf16, P={P}", flush=True)
    rs = np.random.RandomState(0)
    for S in pool_banded_probe.BUCKETS:
        f, b, s = pool_banded_probe.bucket_inputs(rs, S, feats.device)
        part = rp.band_partition(b, 0.125, f.shape[1])
        tile = rp.band_tile(f)
        order = rp.top_row_order(b)

        def kernel():
            return rp.roi_pool_banded(f, b, 0.125, 7, s)

        def plain():
            return rp.roi_pool_banded_plain(f, b, 0.125, 7, s)

        def k1():
            return rp.roi_pool_batched(f, b, 0.125, 7, s)

        ident = identity_order(b)

        def k1_roi_order():
            return rp._launch_batched(f, b, 0.125, 7, s, ident)

        got = kernel()
        torch.cuda.synchronize()
        err = max(err, exact(f"roi_pool_banded at {S}", got, plain()),
                  exact(f"roi_pool_banded at {S} (against K1)", got, k1()),
                  exact(f"roi_pool_banded at {S} (against K1 in RoI order)",
                        got, k1_roi_order()))
        ms, k1_ms = queued_ms(kernel, 20), queued_ms(k1, 20)
        k1_roi_order_ms = queued_ms(k1_roi_order, 20)
        once, bins = cell_reads_gb(f, b)
        single_ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
        out = torch.full_like(got, float("nan"))
        parts = {
            "partition": lambda: rp.band_partition(b, 0.125, f.shape[1]),
            "band launch": lambda: rp._launch_band(
                f, b, 0.125, 7, s, part, tile, 48, out),
            "top_row_order": lambda: rp.top_row_order(b),
            "rest launch": lambda: rp._launch_rest(
                f, b, 0.125, 7, s, order, part.short, out)}
        split = {name: queued_ms(fn, 20) for name, fn in parts.items()}
        exact(f"roi_pool_banded at {S} (its two launches alone)", out, got)
        band_ms, out_b, band_b = band_launch_bound(f, part)
        bound = roi_pool_bound(f, b, s, got, 0.125)
        vec = 16 // f.element_size()
        band_smem = min(48, f.shape[1]) * rp.band_pitch(
            f.shape[2], tile.ct // vec) * 16
        longest = part.run_start.diff().max().item()
        print(f"phase 3: roi_pool_banded kernel == plain == roi_pool kernel "
              f"(max|diff| 0.0) at bucket {S}, {tuple(f.shape)} bf16, "
              f"P={P}, the probe's boxes, {part.short.sum().item()} short "
              f"RoIs in {part.num_bands} bands (the longest run "
              f"{longest}), channel tile {tile.ct}, RoI chunk {tile.chunk} "
              f"(a band of {band_smem} B and a table of "
              f"{rp.table_bytes(7, tile.chunk)} B of shared memory): kernel "
              f"{ms:.4f} ms per call queued ({single_ms:.4f} a single call, "
              f"its host issue included), K1 {k1_ms:.4f} ms queued ("
              f"{once / k1_ms:.2f} GB/ms of {once:.2f} GB of reads each RoI "
              f"cell once; {bins:.2f} GB bin by bin), K1 in RoI order "
              f"{k1_roi_order_ms:.4f} ms queued ({once / k1_roi_order_ms:.2f}"
              f" GB/ms), plain {plain_ms:.4f} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}); library n/a, as K1 {tag}", flush=True)
        print(f"phase 3: roi_pool_banded parts at bucket {S}, ms per call "
              f"queued, each alone: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; sum {sum(split.values()):.4f} of K3's {ms:.4f} (K1 "
              f"{k1_ms:.4f}, K3 / K1 {ms / k1_ms:.3f}); the band launch's "
              f"bound {band_ms:.4f} ms (bytes: {out_b / 1e6:.0f} MB of short "
              f"RoI outputs, {band_b / 1e6:.0f} MB of staged bands), "
              f"bound / time {band_ms / split['band launch']:.1%} {tag}",
              flush=True)
        del got, out, f
    return kernel_entry(
        "roi_pool_banded", "drn_wsod_torch/ops/csrc/roi_pool_banded.cu",
        "drn_wsod_tpu/ops/roi_pool_pallas.py:948 (_banded_launch :897, "
        "pallas_call :927)", err, ms, plain_ms, bound)


def k4_issue_split(x, kind, calls: int = 1000) -> dict:
    """Host us per call of each part of K4's wrapper, ``time.perf_counter``
    over ``calls`` calls each (the card idle at the start of each part):
    its checks, its allocation, the raw stream lookup (and the
    ``torch.cuda.current_stream`` object it replaced), the ctypes call with
    its launch and without it (a call the C side refuses), the whole
    wrapper, and ``torch.maximum`` of the halves where torch has it."""
    from drn_wsod_torch.ops import _build
    from drn_wsod_torch.ops import narrow_max as nm

    spec = nm._SPECS[kind]
    device = x.get_device()
    shape = (x.shape[0] >> 1, *x.shape[1:])
    out = x.new_empty(shape)
    fn = nm._kernel()
    args = (x.data_ptr(), out.data_ptr(), x.nbytes // 2, spec[1],
            _build.raw_stream(device))
    lo, hi = x[:shape[0]], x[shape[0]:]
    parts = {
        "checks": lambda: nm._half_bytes(x, kind, spec),
        "new_empty": lambda: x.new_empty(shape),
        "raw stream": lambda: _build.raw_stream(device),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(
            device).cuda_stream,
        "ctypes call and launch": lambda: fn(*args),
        # the C side refuses a half of 0 bytes before any CUDA call
        "ctypes call alone": lambda: fn(args[0], args[1], 0, *args[3:]),
        "wrapper": lambda: nm.narrow_max(x, kind),
        "torch.maximum": lambda: torch.maximum(lo, hi)}
    split = {}
    for name, part in parts.items():
        try:
            part()
        except (RuntimeError, NotImplementedError):
            continue                    # torch.maximum: no such kernel
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            part()
        split[name] = (time.perf_counter() - t) / calls * 1e6
        torch.cuda.synchronize()
    if kind == "int4":
        split.pop("torch.maximum", None)    # torch has no int4 dtype
    return split


def issued_ms(fns: dict, calls: int = 200, turns: int = 5) -> dict:
    """Per-call device ms of each of ``fns`` issued with the card idle
    (``ablate_bench.cuda_ms``: CUDA events around ``calls`` calls, so the
    host's issue rate), taken in turns ``turns`` times; the median of each.
    Host times on a shared machine drift, so versions compared are timed
    in alternation."""
    from drn_wsod_torch.tools.ablate_bench import cuda_ms as per_call_ms

    runs = {name: [] for name in fns}
    for _ in range(turns):
        for name, fn in fns.items():
            runs[name].append(per_call_ms(fn, calls))
    return {name: statistics.median(r) for name, r in runs.items()}


def phase3_narrow_max(dev, tag) -> dict:
    """K4 in each dtype, bit for bit against its plain version on the dtype
    probe's input and on seeded random bit patterns of the same (16, 512)
    shape; device ms per launch over 200 queued launches (and the host's
    rate, 200 launches issued with the card idle), and ``torch.maximum`` of
    the halves where torch has it for the dtype."""
    from drn_wsod_torch.ops import narrow_max as nm

    gen = torch.Generator(device=dev).manual_seed(4)
    kernels = {}
    for kind in nm.KINDS:
        probe_x = nm.probe_input(kind, dev)
        raw = torch.randint(0, 256, (16, probe_x[0].numel()
                                     * probe_x.element_size()),
                            generator=gen, device=dev, dtype=torch.uint8)
        for what, x in (("probe input", probe_x),
                        ("random bits", raw.view(nm.DTYPES[kind]))):
            got = nm.narrow_max(x, kind)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.uint8),
                               nm.narrow_max_plain(x, kind).view(
                                   torch.uint8)):
                raise Fail(f"phase 3: narrow_max {kind} kernel differs from "
                           f"plain on the {what}")
        x = raw.view(nm.DTYPES[kind])
        ms = queued_ms(lambda: nm.narrow_max(x, kind), 200)
        plain_ms = queued_ms(lambda: nm.narrow_max_plain(x, kind), 200)
        lo, hi = x[:8], x[8:]
        issue = {"kernel": lambda: nm.narrow_max(x, kind)}
        try:
            torch.maximum(lo, hi)
        except (RuntimeError, NotImplementedError) as e:
            library_ms, library = None, f"n/a ({str(e).splitlines()[0]})"
        else:
            library_ms = queued_ms(lambda: torch.maximum(lo, hi), 200)
            issue["torch.maximum"] = lambda: torch.maximum(lo, hi)
        issued = issued_ms(issue)
        host_ms = issued["kernel"]
        if "torch.maximum" in issued:
            library = (f"{library_ms:.5f} ms queued, "
                       f"{issued['torch.maximum']:.5f} issued")
        if kind == "int4":
            library_ms, library = None, "n/a (torch has no int4 dtype)"
        split = k4_issue_split(x, kind)
        print(f"phase 3: narrow_max_{kind} host issue, us per call over "
              f"1000 calls (time.perf_counter): "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f" {tag}", flush=True)
        nbytes = 1.5 * x.numel() * x.element_size()
        bound = (nbytes / PEAK_BYTES_S * 1e3, "bytes")
        print(f"phase 3: narrow_max_{kind} kernel == plain bit for bit on "
              f"the probe input and on random bits, {tuple(x.shape)} "
              f"{x.dtype}: kernel {ms:.5f} ms queued ({host_ms:.5f} issued "
              f"with the card idle, median of 5 turns with torch.maximum's), "
              f"plain {plain_ms:.5f} ms queued, bound "
              f"{bound[0]:.2e} ms (bytes, {nbytes:.0f} B), torch.maximum "
              f"{library} {tag}", flush=True)
        kernels[f"narrow_max_{kind}"] = kernel_entry(
            f"narrow_max_{kind}", "drn_wsod_torch/ops/csrc/narrow_max.cu",
            "tools/mosaic_dtype_probe.py:18 (pallas_call :27)", 0.0, ms,
            plain_ms, bound, library_ms)
    return kernels


def phase4_detect(dev, gen, tag) -> dict:
    import drn_wsod_torch
    from drn_wsod_torch.tools import ablate_bench

    # B=2 batches without TTA; phase 10 runs the flagship's TTA protocol
    cfg = ablate_bench.flagship_cfg(overrides=("TEST.AUG.ENABLED", False))
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
    reset_launches()
    with ClockSampler() as clock_sampler:
        outs = [detect(batch) for batch in batches[:WARMUP]]
        torch.cuda.synchronize()
        windows = []
        for _ in range(WINDOWS):
            w = timed_window(detect, batches[WARMUP:])
            outs += w[0]
            windows.append(w[1:])
        launches = read_launches()
        # the per-part split runs after the count is read: its hooks make
        # these requests differ from a caller's
        parts = [split_request(model, detect,
                               batches[WARMUP + i % REQUESTS])
                 for i in range(SPLITS)]

    n_req = WARMUP + WINDOWS * REQUESTS
    if launches["roi_pool"] != n_req:
        raise Fail(f"phase 4: roi_pool launched {launches['roi_pool']} "
                   f"times for {n_req} requests")
    for dets in outs:
        shapes = {k: tuple(v.shape) for k, v in dets.items()}
        want_shapes = {"boxes": (B, topk, 4), "scores": (B, topk),
                       "classes": (B, topk), "valid": (B, topk),
                       "all_scores": (B, P, C + 1), "all_boxes": (B, P, 4)}
        if shapes != want_shapes:
            raise Fail(f"phase 4: output shapes {shapes}")
        finite = all(torch.isfinite(v.float()).all().item()
                     for v in dets.values())
        row_sums = dets["all_scores"].sum(-1)
        if (not finite or not dets["valid"].any()
                or (row_sums - 1).abs().max().item() > 1e-4
                or (dets["scores"] < 0).any() or (dets["scores"] > 1).any()
                or (dets["classes"][dets["valid"]] >= C).any()):
            raise Fail("phase 4: outputs not finite, empty or out of range")
    print(f"phase 4: {n_req} detect requests (B={B}, {IMG}x{IMG}, P={P}, "
          f"R50-WS DC5, DAN [2048, 4096], 3 OICR branches, bf16); "
          f"launches {launches} (roi_pool once per request); "
          f"outputs finite, shapes {shapes}", flush=True)
    print_windows("phase 4", "requests", REQUESTS, windows, tag)
    print(f"phase 4: peak device memory of the requests "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {tag}",
          flush=True)
    print_split("phase 4", "requests", parts, tag)
    print(f"phase 4: card during the requests: {clock_sampler.summary} "
          f"{tag}", flush=True)
    return launches


def phase5_train(dev, gen, tag) -> dict:
    import drn_wsod_torch
    from drn_wsod_torch.tools import ablate_bench

    cfg = ablate_bench.flagship_cfg()
    model = drn_wsod_torch.build_model(cfg, device=dev, generator=gen)
    tx = drn_wsod_torch.build_optimizer(cfg, model)
    state = drn_wsod_torch.create_train_state(model, tx)
    step = drn_wsod_torch.make_train_step(model, tx)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    batches = [drn_wsod_torch.synthetic_batch(B, IMG, IMG, P, C, seed=100 + s,
                                              device=dev)
               for s in range(TRAIN_WARMUP + TRAIN_STEPS)]
    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    start = {n: p.detach().clone() for n, p in trainable.items()}
    frozen = {n: t.clone() for n, t in model.state_dict().items()
              if n not in trainable}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with ClockSampler() as clock_sampler:
        metrics = [step(state, b, 0)[1] for b in batches[:TRAIN_WARMUP]]
        torch.cuda.synchronize()
        windows = []
        for _ in range(TRAIN_WINDOWS):
            w = timed_window(lambda b: step(state, b, 0)[1],
                             batches[TRAIN_WARMUP:])
            metrics += w[0]
            windows.append(w[1:])
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        parts = [split_step(model, tx, step, state,
                            batches[TRAIN_WARMUP + i % TRAIN_STEPS])
                 for i in range(TRAIN_SPLITS)]

    n_steps = TRAIN_WARMUP + TRAIN_WINDOWS * TRAIN_STEPS
    if launches["roi_pool"] != n_steps:
        raise Fail(f"phase 5: roi_pool launched {launches['roi_pool']} "
                   f"times for {n_steps} steps")
    names = {"loss_cls", "loss_cls_r0", "loss_cls_r1", "loss_cls_r2",
             "total_loss"}
    values = [{k: v.item() for k, v in m.items()} for m in metrics]
    if any(set(v) != names or not all(map(math.isfinite, v.values()))
           for v in values):
        raise Fail(f"phase 5: losses not finite or misnamed: {values}")
    changed = [n for n, t in frozen.items()
               if not torch.equal(t, model.state_dict()[n])]
    if changed:
        raise Fail(f"phase 5: frozen tensors changed: {changed[:5]}")
    # a parameter moves exactly where its momentum trace is nonzero (the
    # bbox_pred biases of branches without box regression get neither a
    # gradient nor weight decay)
    still = [n for n, p in trainable.items()
             if torch.equal(p, start[n])
             != bool((state.opt_state["trace"][n] == 0).all())]
    moved = [n for n, p in trainable.items() if not torch.equal(p, start[n])]
    if still or "box_head.fc1.weight" not in moved:
        raise Fail(f"phase 5: trainable parameters did not move as their "
                   f"updates say: {still}")
    first, last = values[0], values[-1]
    print(f"phase 5: {n_steps} train steps (B={B}, {IMG}x{IMG}, P={P}, "
          f"flagship solver: BASE_LR {cfg.SOLVER.BASE_LR}, WD "
          f"{cfg.SOLVER.WEIGHT_DECAY}, BIAS_LR_FACTOR "
          f"{cfg.SOLVER.BIAS_LR_FACTOR}, dropout "
          f"{cfg.MODEL.ROI_BOX_HEAD.DROPOUT}, bf16); launches {launches} "
          f"(roi_pool once per step); losses finite, first step "
          f"{json.dumps(first)}, last {json.dumps(last)}; "
          f"{len(frozen)} frozen tensors bit-unchanged; "
          f"{len(moved)} of {len(trainable)} trainable moved", flush=True)
    print_windows("phase 5", "steps", TRAIN_STEPS, windows, tag)
    print(f"phase 5: peak device memory of the steps {peak / 2**30:.2f} GiB "
          f"{tag}", flush=True)
    print_split("phase 5", "steps", parts, tag)
    print(f"phase 5: card during the steps: {clock_sampler.summary} {tag}",
          flush=True)
    return launches


def phase6_ablate(tag) -> dict:
    from drn_wsod_torch.tools import ablate_bench

    reset_launches()
    rows = ablate_bench.run(
        ABLATE_ITERS, emit=lambda r: print(
            "phase 6: " + ablate_bench.format_row(r, tag), flush=True))
    launches = read_launches()
    calls = {r.name: r.calls for r in rows}
    for name, key in ((f"K2 pool, looped per image (B={B})",
                       "roi_pool_image"),
                      (f"K2 pool, looped per image, int8 (B={B})",
                       "roi_pool_image_int8")):
        if launches[key] != B * calls[name]:
            raise Fail(f"phase 6: {key} launched {launches[key]} times in "
                       f"{calls[name]} looped calls of B={B}")
    if launches["roi_pool"] == 0:
        raise Fail("phase 6: the tool's train steps launched no roi_pool")
    if not all(math.isfinite(r.ms) and r.ms > 0 for r in rows):
        raise Fail(f"phase 6: a time is not positive: {rows}")
    print(f"phase 6: launches {launches} ({B} K2 launches per looped call, "
          f"in each mode)", flush=True)
    return launches


def phase7_banded_probe(tag) -> dict:
    from drn_wsod_torch.tools import pool_banded_probe

    reset_launches()
    rows = pool_banded_probe.run(
        pool_banded_probe.BUCKETS, PROBE_ITERS,
        emit=lambda r: print("\n".join(
            "phase 7: " + line
            for line in pool_banded_probe.format_bucket(r, tag)), flush=True))
    launches = read_launches()
    calls = sum(r.calls for r in rows)
    want = {"roi_pool": calls, "roi_pool_banded": calls,
            "roi_pool_banded_rest": calls}
    got = {k: launches[k] for k in want}
    if got != want:
        raise Fail(f"phase 7: launches {got} for {calls} calls of each path")
    if any(r.max_diff != 0.0 for r in rows):
        raise Fail(f"phase 7: classic and banded differ: {rows}")
    print(f"phase 7: launches {launches} ({calls} calls of each path: one "
          f"K1 launch per classic call, one launch of each K3 kernel per "
          f"banded call)", flush=True)
    return launches


def phase8_dtype_probe(tag) -> dict:
    from drn_wsod_torch.tools import mosaic_dtype_probe

    reset_launches()
    rows = mosaic_dtype_probe.run(emit=lambda kind, result: print(
        f"phase 8: {kind:16s} {result} {tag}", flush=True))
    launches = read_launches()
    bad = [(k, r) for k, r in rows
           if r != "OK" or launches[f"narrow_max_{k}"] != 1]
    if bad:
        raise Fail(f"phase 8: {bad}; launches {launches}")
    print(f"phase 8: launches {launches} (one K4 launch per dtype)",
          flush=True)
    return launches


def phase9_tests(tag) -> None:
    root = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py"],
        cwd=root, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(root)})
    summary = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode != 0 or not re.fullmatch(
            r"=* *\d+ passed(, \d+ warnings?)? in .*", summary):
        raise Fail(f"phase 9: tests/test_torch_cuda.py: {summary}\n"
                   f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    print(f"phase 9: tests/test_torch_cuda.py on the card: {summary} {tag}",
          flush=True)


def eval_image(rs, H, W, index, P=P, C=20):
    """A u8 (H, W, 3) image drawn from ``rs`` and its record: P VOC-like
    proposals (log-uniform sides, inside the image, XYXY, objectness
    descending) and 1-3 GT boxes of random classes."""
    image = rs.randint(0, 256, (H, W, 3)).astype(np.uint8)
    w = np.exp(rs.uniform(np.log(8), np.log(W), P))
    h = np.clip(w * np.exp(rs.uniform(-1, 1, P)), 8, H)
    x1 = rs.uniform(0, W - w)
    y1 = rs.uniform(0, H - h)
    boxes = np.stack([x1, y1, x1 + w - 1, y1 + h - 1], 1).astype(np.float32)
    gt = []
    for _ in range(rs.randint(1, 4)):
        i = rs.randint(P)
        gt.append({"category_id": int(rs.randint(C)),
                   "bbox": [float(v) for v in boxes[i]], "difficult": 0})
    return image, {
        "image_id": f"{index:06d}", "height": H, "width": W,
        "proposal_boxes": boxes,
        "proposal_objectness_logits": np.sort(
            rs.uniform(-1, 1, P)).astype(np.float32)[::-1].copy(),
        "annotations": gt}


def view_build_ms(tta, image, record, bucket: int) -> dict:
    """Device ms of one bucket group's view build alone (median of 5 calls
    each): ``_device_view_batch`` whole, and one view's ``scale_linear``
    (the resize's two float32 products) and ``weight_mat`` pair."""
    from drn_wsod_torch import tta as tta_mod
    from drn_wsod_torch.ops.resize import scale_linear, weight_mat

    dev = tta.device
    H0, W0 = image.shape[:2]
    rb = int(np.ceil(max(H0, W0) / 256) * 256)
    raw = torch.from_numpy(np.pad(image, ((0, rb - H0), (0, rb - W0),
                                          (0, 0)), mode="edge")).to(dev)
    views = tta.groups((H0, W0))[bucket]
    P = tta.num_proposals
    boxes = torch.zeros(P, 4, device=dev)
    mask = torch.ones(P, dtype=torch.bool, device=dev)
    nh, nw, _ = views[0]
    sy = torch.full((), nh / H0, device=dev)
    sx = torch.full((), nw / W0, device=dev)
    rawf = raw.float()
    return {
        f"_device_view_batch ({len(views)} views)": cuda_ms(
            lambda: tta_mod._device_view_batch(
                raw, (H0, W0), [(h, w) for h, w, _ in views],
                [f for _, _, f in views], bucket, boxes, mask,
                torch.zeros(P, device=dev), torch.zeros(20, device=dev)), 5),
        "scale_linear (one view)": cuda_ms(
            lambda: scale_linear(rawf, (bucket, bucket), sy, sx), 5),
        "weight_mat pair (one view)": cuda_ms(
            lambda: (weight_mat(rb, bucket, sy), weight_mat(rb, bucket, sx)),
            5)}


def phase10_eval(dev, gen, tag) -> dict:
    """The flagship's own eval protocol (TTA-AVG over 8 scales x flip, one
    NMS, VOC AP and CorLoc) through ``GeneralizedRCNNWithTTAAVG.
    detect_image`` at full width on VOC-sized images: per image ms by CUDA
    events and the host clock, views, groups, K1 launches (one per group),
    then a per-part split of each timed image, K1 against its plain version
    on the largest group's own inputs, and the evaluator's metrics."""
    import drn_wsod_torch
    from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES
    from drn_wsod_torch.models import meta_arch
    from drn_wsod_torch.ops import roi_pool as rp
    from drn_wsod_torch.tools import ablate_bench

    cfg = ablate_bench.flagship_cfg()
    aug = cfg.TEST.AUG
    if not (aug.ENABLED and aug.DEVICE_VIEWS and aug.FLIP
            and len(aug.MIN_SIZES) == 8 and aug.MAX_SIZE == 4000):
        raise Fail(f"phase 10: the flagship's TEST.AUG is not its YAML's: "
                   f"{aug}")
    model = drn_wsod_torch.build_model(cfg, device=dev, generator=gen)
    tta = drn_wsod_torch.GeneralizedRCNNWithTTAAVG(cfg, model, device=dev)
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    topk = cfg.TEST.DETECTIONS_PER_IMAGE
    rs = np.random.RandomState(7)
    images = [eval_image(rs, H, W, i) for i, (H, W) in
              enumerate(EVAL_SIZES[:EVAL_WARMUP] + EVAL_SIZES)]
    groups = {}
    for image, record in images:
        groups[record["image_id"]] = {
            b: len(v) for b, v in tta.groups(image.shape[:2]).items()}
    if groups["000000"] != {704: 2, 896: 4, 1216: 4, 1280: 2, 1408: 2,
                            1536: 2}:
        raise Fail(f"phase 10: 500x375 groups {groups['000000']}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rows, outs = [], []
    with ClockSampler() as clock_sampler:
        for image, record in images:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            before = rp.roi_pool_batched.launches
            t = time.perf_counter()
            start.record()
            outs.append(tta.detect_image(image, record))
            end.record()
            end.synchronize()
            rows.append(((time.perf_counter() - t) * 1e3,
                         start.elapsed_time(end),
                         rp.roi_pool_batched.launches - before))
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        # the per-part split runs after the count is read: its hooks make
        # these images differ from a caller's
        parts = [split_tta(model, tta, *im) for im in images[EVAL_WARMUP:]]

    for (image, record), (_, _, k1), dets in zip(images, rows, outs):
        H, W = image.shape[:2]
        n_groups = len(groups[record["image_id"]])
        if k1 != n_groups:
            raise Fail(f"phase 10: image {record['image_id']} ({W}x{H}): "
                       f"K1 launched {k1} times for {n_groups} groups")
        b, v = dets["boxes"], dets["valid"]
        if ({k: a.shape for k, a in dets.items()} != {
                "boxes": (topk, 4), "scores": (topk,), "classes": (topk,),
                "valid": (topk,), "all_scores": (P, C + 1),
                "all_boxes": (P, 4)}
                or not all(np.isfinite(a.astype(np.float64)).all()
                           for a in dets.values())
                or not v.any() or (b[v] < 0).any()
                or (b[v][:, [0, 2]] > W).any() or (b[v][:, [1, 3]] > H).any()
                or (dets["classes"][v] >= C).any()):
            raise Fail(f"phase 10: image {record['image_id']} ({W}x{H}): "
                       "detections not finite, empty or outside the image")
    if launches["roi_pool"] != sum(r[2] for r in rows):
        raise Fail(f"phase 10: launches {launches}")

    evaluator = drn_wsod_torch.PascalVOCDetectionEvaluator(
        VOC_CLASS_NAMES, {r["image_id"]: r["annotations"]
                          for _, r in images[EVAL_WARMUP:]}, 2007)
    for (_, record), dets in zip(images[EVAL_WARMUP:], outs[EVAL_WARMUP:]):
        evaluator.process_single(record["image_id"], dets["boxes"],
                                 dets["scores"], dets["classes"],
                                 dets["valid"])
    res = evaluator.evaluate()
    metrics = {**{k: res["bbox"][k] for k in ("AP", "AP50", "AP75")},
               **{k: res["bbox CorLoc"][k] for k in ("CL", "CL50", "CL75")}}
    if not all(math.isfinite(x) and 0.0 <= x <= 100.0
               for x in metrics.values()):
        raise Fail(f"phase 10: evaluator metrics {metrics}")

    # K1 on the largest group's own inputs: the 500x375 image's 1216 bucket
    # (the larger of its two 4-view groups; 2048-channel bf16 maps, the
    # views' own proposals)
    captured = {}
    pool = meta_arch.roi_pool_batched

    def capture(feats, boxes, spatial_scale, R, roi_scale):
        if feats.shape[0] == 4:
            captured[feats.shape[1]] = (feats.clone(), boxes.clone(),
                                        roi_scale.clone())
        return pool(feats, boxes, spatial_scale, R, roi_scale)

    meta_arch.roi_pool_batched = capture
    try:
        tta.detect_image(*images[0])
    finally:
        meta_arch.roi_pool_batched = pool
    feats, boxes, scale = captured[max(captured)]

    def k1():
        return rp.roi_pool_batched(feats, boxes, 0.125, 7, scale)

    def plain():
        return rp.roi_pool_plain(feats, boxes, 0.125, 7, scale)

    got = k1()
    torch.cuda.synchronize()
    err = exact("roi_pool at the 1216 TTA group", got, plain(), phase=10)
    ms, plain_ms = queued_ms(k1, 20), cuda_ms(plain, 3)
    bound_ms, bound_by = roi_pool_bound(feats, boxes, scale, got, 0.125)
    k1_shape = (tuple(feats.shape), tuple(boxes.shape))
    del got, captured, feats
    views_ms = view_build_ms(tta, *images[0], 1216)

    timed = rows[EVAL_WARMUP:]
    for (image, record), (host, device, k1n), (dev_p, host_p) in zip(
            images[EVAL_WARMUP:], timed, parts):
        H, W = image.shape[:2]
        g = groups[record["image_id"]]
        print(f"phase 10: image {record['image_id']} {W}x{H}: "
              f"{sum(g.values())} views in {len(g)} groups "
              f"{json.dumps(g)}, K1 launches {k1n}; {device:.3f} ms by CUDA "
              f"events, {host:.3f} ms by the host clock; split (hooked "
              "run), device ms: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in dev_p.items())
              + f" (sum {sum(dev_p.values()):.3f}); host-issue ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in host_p.items())
              + f" {tag}", flush=True)
    dev_ms = [r[1] for r in timed]
    host_ms = [r[0] for r in timed]
    med = {k: statistics.median(p[0][k] for p in parts) for k in parts[0][0]}
    print(f"phase 10: {len(images)} images ({EVAL_WARMUP} warm-up) through "
          f"GeneralizedRCNNWithTTAAVG.detect_image, flagship at full width "
          f"(R50-WS DC5, DAN [2048, 4096], 3 OICR branches, bf16, seeded "
          f"random weights), TTA-AVG {len(aug.MIN_SIZES)} scales x flip, "
          f"MAX_SIZE {aug.MAX_SIZE}, views on the device, P={P}, "
          f"{topk} detections per image; launches {launches} (K1 once per "
          f"group: {sum(r[2] for r in rows)} for "
          f"{sum(len(g) for g in groups.values())} groups); detections "
          f"finite and inside their images", flush=True)
    print(f"phase 10: ms per image over the {len(timed)} timed images: by "
          f"CUDA events median {statistics.median(dev_ms):.3f}, mean "
          f"{statistics.mean(dev_ms):.3f} (min {min(dev_ms):.3f}, max "
          f"{max(dev_ms):.3f}); by the host clock median "
          f"{statistics.median(host_ms):.3f}, mean "
          f"{statistics.mean(host_ms):.3f}; warm-up "
          f"{', '.join(f'{r[1]:.3f}' for r in rows[:EVAL_WARMUP])} ms; "
          f"peak device memory {peak / 2**30:.2f} GiB; device ms per part, "
          f"median over the timed images: "
          + ", ".join(f"{k} {v:.3f}" for k, v in med.items()) + f" {tag}",
          flush=True)
    print(f"phase 10: roi_pool kernel == plain (max|diff| {err}) on the "
          f"1216 group's own inputs (the 500x375 image's 4 views: map "
          f"{k1_shape[0]} bf16, boxes {k1_shape[1]}): kernel {ms:.4f} ms "
          f"queued, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) {tag}",
          flush=True)
    print(f"phase 10: view build alone, the 500x375 image's 1216 group ("
          f"raw image edge-padded to 512x512), ms by CUDA events: "
          + ", ".join(f"{k} {v:.4f}" for k, v in views_ms.items())
          + f" {tag}", flush=True)
    print(f"phase 10: VOC evaluator on the {len(timed)} timed images: "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
          + " (finite, in [0, 100]; random weights and synthetic GT: the "
          "values mean nothing)", flush=True)
    print(f"phase 10: card during the images: {clock_sampler.summary} {tag}",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    from drn_wsod_torch.tools.ablate_bench import card

    card_line = card()
    tag = f"[{card_line}]"
    print(f"phase 1: card {card_line}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    # the port's float32 paths run in full float32; the flagship runs bf16
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from drn_wsod_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"phase 2: built {sorted(logs)} in "
          f"{time.perf_counter() - t0:.2f} s, one nvcc per source in parallel "
          f"{tag}", flush=True)
    for name, log in logs.items():
        for kernel, lines in ptxas_report(log):
            print(f"  {name}: {kernel}: {'; '.join(lines)}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        kernels = phase3_kernels(dev, gen, tag)
        paths = {}
        for name, phase in (("detect", lambda: phase4_detect(dev, gen, tag)),
                            ("train", lambda: phase5_train(dev, gen, tag)),
                            ("ablate", lambda: phase6_ablate(tag)),
                            ("banded_probe", lambda: phase7_banded_probe(tag)),
                            ("dtype_probe", lambda: phase8_dtype_probe(tag))):
            paths[name] = phase()
            torch.cuda.empty_cache()
        phase9_tests(tag)
        paths["eval"] = phase10_eval(dev, gen, tag)
    except Fail as e:
        print(f"FAIL {e}")
        return 1
    # K3 is two kernels, both launched once per call
    counted = {"roi_pool_banded": ("roi_pool_banded", "roi_pool_banded_rest")}
    for k in kernels.values():
        k["launches"] = sum(p[c] for p in paths.values()
                            for c in counted.get(k["name"], (k["name"],)))
    idle = [k["name"] for k in kernels.values() if k["launches"] == 0]
    if idle:
        print(f"FAIL no path launched {idle}")
        return 1
    print(f"launches per path: {json.dumps(paths)}")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
