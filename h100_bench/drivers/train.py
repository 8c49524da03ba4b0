"""Training cells: the program's ``Trainer.train`` over ``make_train_step``
with its train loader on a packed shard, built as
``drn_wsod_torch/tools/train_net.py:do_train`` builds them (one rank's mesh,
the chunk of ``steps_per_dispatch`` steps, the prefetch), with the
``IterationTimer`` hook and the harness's own window hook; no checkpoint,
evaluation or writer hook, whose periods lie outside every window.

Set-up: records from the seed, packed into a shard under ``TMPDIR`` and
registered; the model built and given the benchmark's weights; the first
three steps driven through ``Trainer.train`` one at a time (their batches,
losses, the optimizer's trace after the first and the parameters after the
third kept for the reference); a forward at every bucket the traffic can
produce; then, inside one further ``Trainer.train`` call, its first chunk
(the loader and the prefetch reach their pace). The window: the chunks
after it until ``seconds`` have passed, each chunk's end fenced by a
synchronise; every step it completed counts (``Plan``). Where the cell
reports an end-to-end metric read from the device's trace
(``train_busy_ms_per_img``), the whole window runs under the profiler
(the CUDA activity only): the union of the device's operation intervals
over the window, a training image at a time.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch

from h100_bench import harness
from h100_bench.flops import image_flops
from h100_bench.trace import Trace, events, profiler, union_s
from h100_bench.reference import arch as arch_lib
from h100_bench.reference.model import WSDDN_LEAVES
from h100_bench.traffic.generate import make_records
from h100_bench.yardstick import train_buckets

DATASET = "h100_bench_train"
CHECKED_STEPS = 3


class WindowClosed(Exception):
    """Raised by the window hook once the window's time has passed."""


class Feed:
    """The loader's iterator as the Trainer pulls it, noting each batch's
    shapes in order (within one ``Trainer.train`` call the prefetch pulls
    them in step order), keeping whole the first ``keep`` batches and,
    with ``keep_boxes``, every batch's masked proposals."""

    def __init__(self, it, keep: int, keep_boxes: bool):
        self._it, self.keep, self.keep_boxes = it, keep, keep_boxes
        self.seen = []            # (image_hw (B, 2), n_valid (B,), side)
        self.kept = []
        self.boxes = []           # masked (B, P, 4) CPU proposals

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self._it)
        i = len(self.seen)
        self.seen.append((b.image_hw.numpy().copy(),
                          b.proposal_mask.sum(1).numpy().copy(),
                          int(b.image.shape[1])))
        if i < self.keep:
            self.kept.append({k: v.clone() for k, v in b.tensors().items()})
        if self.keep_boxes:
            self.boxes.append(torch.where(b.proposal_mask[..., None],
                                          b.proposals, 0.0))
        return b


class Plan:
    """The window inside one ``Trainer.train`` call, acted on at the end of
    each chunk of ``k`` steps (the steps are issued; a synchronise fences
    them): the first chunk lets the loader and the prefetch reach their
    pace (set-up), then the window runs until ``seconds`` have passed.
    Traced, the window is ``seconds / 4`` untraced (at least one chunk, as
    the TTA cell's) and then as many steps under the profiler: a PCL step
    issues some 59,000 device operations, and on an H100 a traced run of 40
    PCL steps took 290 of the 360 seconds a run may have. Untraced, with
    ``busy``, the whole window runs under the profiler."""

    def __init__(self, trainer, hook, k, seconds, trace, dev, busy=False):
        self.trainer, self.hook, self.k = trainer, hook, k
        self.seconds, self.trace, self.dev = seconds, trace, dev
        self.busy = busy and not trace
        self.start = trainer.state.step
        self.phase, self.prof = "ramp", None
        self.out = {}

    def chunk_end(self):
        harness.sync(self.dev)
        now, step = harness.now(), self.trainer.state.step
        o = self.out
        if self.phase == "ramp":
            harness.log("ramp chunk done: the window opens")
            o.update(setup_s=harness.process_age_s(), s0=step,
                     data0=self.hook.data_time)
            self.t0, self.phase = now, "window"
            self.host0 = self.host_c = harness.host_sample()
            self.step_c = step
            if self.busy:
                self.prof = profiler()
                self.prof.start()
        elif self.phase == "window":
            host = harness.host_sample()
            load = harness.host_load(self.host_c, host)
            harness.log(f"chunk: {step - self.step_c} steps in "
                        f"{host[0] - self.host_c[0]:.3f} s; this process "
                        f"{load['process_cores']:.2f} cores")
            self.host_c, self.step_c = host, step
            if now - self.t0 < (self.seconds / 4 if self.trace
                                else self.seconds):
                return
            o.update(n=step - o["s0"], secs=now - self.t0,
                     data_time_s=self.hook.data_time - o["data0"],
                     host=harness.host_load(self.host0, host))
            if not self.trace:
                if self.prof is not None:
                    self.prof.stop()
                raise WindowClosed()
            self.prof = profiler()
            self.prof.start()
            o["s1"], self.t1, self.phase = step, harness.now(), "traced"
        elif step - o["s1"] >= o["n"]:
            o["traced_s"] = harness.now() - self.t1
            self.prof.stop()
            harness.log("profiler stopped")
            raise WindowClosed()


def _hook_class():
    from drn_wsod_torch.engine.hooks import HookBase

    class WindowHook(HookBase):
        """Sums the loop's wait for batches (``data_time``, per step) and
        hands each chunk's end to the window's plan."""

        def __init__(self):
            self.plan = None
            self.data_time = 0.0

        def after_step(self):
            self.data_time += float(self.trainer._pending_data_time)
            p = self.plan
            if p is not None and \
                    (self.trainer.iter - p.start) % p.k == p.k - 1:
                p.chunk_end()

    return WindowHook


def _program(cfg, dev, W, keep_boxes):
    """The model with the benchmark's weights, the loader, and the Trainer
    as ``do_train`` builds them."""
    from drn_wsod_torch.data import DatasetMapper, build_detection_train_loader
    from drn_wsod_torch.engine import (IterationTimer, Trainer,
                                       create_train_state)
    from drn_wsod_torch.engine import trainer as trainer_lib
    from drn_wsod_torch.models import build_model
    from drn_wsod_torch.parallel.mesh import create_mesh
    from drn_wsod_torch.parallel.train_parallel import make_sharded_train_step
    from drn_wsod_torch.solver import build_optimizer
    from drn_wsod_torch.solver.build import build_lr_schedule
    from drn_wsod_torch.tools.train_net import LOG_PERIOD, steps_per_dispatch

    model = build_model(cfg, device=dev)
    harness.load_into(model, W)
    mesh = create_mesh(tuple(cfg.PARALLEL.MESH_AXES),
                       tuple(cfg.PARALLEL.MESH_SHAPE))
    loader = build_detection_train_loader(cfg, DatasetMapper(cfg, True),
                                          process_index=mesh.data_rank,
                                          process_count=mesh.data_size)
    tx = build_optimizer(cfg, model)
    state = create_train_state(model, tx)
    step = make_sharded_train_step(model, tx, mesh, state=state)
    k = steps_per_dispatch(cfg)
    feed = Feed(iter(loader), CHECKED_STEPS, keep_boxes)
    trainer = Trainer(
        step, state, feed, seed=max(cfg.SEED, 0),
        lr_schedule=build_lr_schedule(cfg), log_period=LOG_PERIOD,
        multi_step_fn=trainer_lib.make_multi_train_step(step) if k > 1
        else None, steps_per_dispatch=k, device=dev)
    hook = _hook_class()()
    trainer.register_hooks([IterationTimer(), hook])
    return model, trainer, feed, hook, k


def _warm_buckets(model, cfg, records, dev, seen_sides):
    """The backbone, K1, the DAN and WSDDN (``proposal_scores``, no
    gradient) at every bucket the traffic can produce and the checked steps
    did not: the first call of each shape falls in the set-up. The heads
    after them and the backward see only the P proposal slots, whose shape
    no bucket changes."""
    from drn_wsod_torch.structures.batch import WSODBatch

    sides = train_buckets([(r["height"], r["width"]) for r in records],
                          cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN,
                          tuple(cfg.INPUT.CROP.SIZE), cfg.INPUT.BUCKETS,
                          cfg.INPUT.SIZE_DIVISIBILITY)
    B = cfg.SOLVER.IMS_PER_BATCH
    P = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    C = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    G = cfg.DATASETS.MAX_GT_PER_IMAGE
    boxes = torch.from_numpy(records[0]["proposal_boxes"][:P])
    n = boxes.shape[0]
    for S in sides:
        if S in seen_sides:
            continue
        props = torch.zeros(B, P, 4)
        props[:, :n] = boxes * (S / 500.0)
        mask = torch.zeros(B, P, dtype=torch.bool)
        mask[:, :n] = True
        batch = WSODBatch(
            image=torch.zeros(B, S, S, 3, dtype=torch.uint8),
            image_hw=torch.full((B, 2), S, dtype=torch.int32),
            orig_hw=torch.full((B, 2), S, dtype=torch.int32),
            proposals=props, proposal_mask=mask,
            objectness=torch.zeros(B, P),
            labels=torch.ones(B, C),
            image_id=torch.zeros(B, dtype=torch.int32),
            gt_boxes=torch.zeros(B, G, 4),
            gt_classes=torch.zeros(B, G, dtype=torch.int32),
            gt_valid=torch.zeros(B, G, dtype=torch.bool)).map(
                lambda t: t.to(dev))
        with torch.no_grad():
            model.proposal_scores(batch)
    return sides


def _norms(tensors):
    return {n: float(t.detach().float().norm()) for n, t in tensors.items()}


def run(ctx) -> dict:
    """One run of a training cell: the result's parts and the numbers for
    the check (see ``run.py``)."""
    from drn_wsod_torch.data import DatasetCatalog, MetadataCatalog
    from drn_wsod_torch.data import write_records
    from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES
    from drn_wsod_torch.data.record_dataset import RecordDataset

    dev, seeds = ctx.device, ctx.seeds
    arch = arch_lib.from_config(ctx.conf["merged"])
    cfg = ctx.program_cfg()
    records = make_records(ctx.mix, seeds.traffic, dev, ctx.n_records)
    tmp = tempfile.mkdtemp(prefix="h100_bench_")
    try:
        shard = os.path.join(tmp, "train.rec")
        write_records(shard, records)
        if DATASET in DatasetCatalog:
            DatasetCatalog.remove(DATASET)
        DatasetCatalog.register(DATASET, lambda: list(RecordDataset(shard)))
        MetadataCatalog.get(DATASET).set(thing_classes=list(VOC_CLASS_NAMES),
                                         evaluator_type="pascal_voc",
                                         year=2007)
        harness.log(f"{len(records)} records packed")
        leaves = arch_lib.leaves(arch)
        W = harness.make_weights(leaves, seeds.weights, dev)
        model, trainer, feed, hook, k = _program(cfg, dev, W, ctx.trace)
        del W
        harness.log("model and trainer built")
        trainable = {n: p for n, p in model.named_parameters()
                     if p.requires_grad}
        prog = {"losses": []}
        for i in range(CHECKED_STEPS):
            trainer.train(i, i + 1)
            st = trainer.storage
            prog["losses"].append(
                {n: st.history(n).latest() for n in st.histories()
                 if n.startswith("loss") or n == "total_loss"})
            if i == 0:
                tr = trainer.state.opt_state["trace"]
                prog["trace"] = _norms(tr)
                prog["wsddn_trace"] = {n: tr[n].detach().float().clone()
                                       for n in WSDDN_LEAVES}
        after = {n: p.detach().to("cpu", copy=True)
                 for n, p in trainable.items()}
        harness.log("checked steps done")
        out = {"chunk": k}
        B = cfg.SOLVER.IMS_PER_BATCH
        if ctx.checks_only:
            out.update(setup_s=harness.process_age_s(), failed=0,
                       attempted=0)
        else:
            out["buckets_warmed"] = len(_warm_buckets(
                model, cfg, records, dev, {s for _, _, s in feed.seen}))
            harness.log(f"{out['buckets_warmed']} buckets warmed")
            out.update(_window(ctx, trainer, hook, feed, arch, dev, B, k))
            harness.log("window closed")
        if dev.type == "cuda":
            out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        # the reference: after the window, with the program's state freed
        labels_wrong = 0
        for b in feed.kept:
            for img_id, lab in zip(b["image_id"].tolist(), b["labels"]):
                want = np.zeros(arch.num_classes, np.float32)
                want[[a["category_id"]
                      for a in records[img_id]["annotations"]]] = 1.0
                labels_wrong += int(not np.array_equal(lab.numpy(), want))
        prog["labels_wrong"] = labels_wrong
        del trainable, model, trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["reference"] = lambda variants=("program",): _reference(
            ctx, cfg, arch, leaves, feed, prog, after, variants)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _window(ctx, trainer, hook, feed, arch, dev, B, k) -> dict:
    """``Trainer.train`` from the trainer's step under the window's plan,
    to a horizon (100 steps a second) beyond any window."""
    plan = Plan(trainer, hook, k, ctx.seconds, ctx.trace, dev,
                busy=ctx.window_busy)
    hook.plan = plan
    failed = 0
    start = trainer.state.step
    try:
        trainer.train(start, start + k * (int(ctx.seconds * 100) // k + 2))
    except WindowClosed:
        pass
    except FloatingPointError:
        failed = 1
    hook.plan = None
    harness.sync(dev)
    o = plan.out
    if "n" not in o:
        raise RuntimeError("the window did not close")
    out = {"setup_s": o["setup_s"], "failed": failed, "host": o["host"],
           "attempted": o["n"] * (2 if ctx.trace else 1)}
    if not ctx.trace:
        out["metrics"] = {"train_img_s": o["n"] * B / o["secs"]}
        out.update(steps=o["n"], window_s=o["secs"])
        if plan.prof is not None:
            busy = union_s([(a, b) for _, a, b in events(plan.prof)[0]])
            out["metrics"]["train_busy_ms_per_img"] = \
                1e3 * busy / (o["n"] * B)
            out["window_busy_s"] = busy
        return out
    s0, s1, n = o["s0"], o["s1"], o["n"]

    def flops(first):
        return sum(image_flops(arch, int(h), int(w), int(v), True)
                   for hw, nv, _ in feed.seen[first:first + n]
                   for (h, w), v in zip(hw, nv))

    out["flops"], out["traced_flops"] = flops(s0), flops(s1)
    out["k1_calls"] = [{"batch": B, "map": arch.feature_size(feed.seen[i][2]),
                        "dtype": ctx.conf["merged"]["MODEL"]["DTYPE"],
                        "boxes": feed.boxes[i],
                        "channels": arch.out_channels,
                        "resolution": arch.resolution,
                        "spatial_scale": 1.0 / arch.feature_stride}
                       for i in range(s1, s1 + n)]
    dev_events, host_events = events(plan.prof)
    harness.log(f"{len(dev_events)} device events read")
    out.update(kind="train", batch=B, untraced_n=n, untraced_s=o["secs"],
               data_time_s=o["data_time_s"], traced_n=n,
               trace=Trace(device=dev_events, host=host_events,
                           window_s=o["traced_s"]))
    return out


def _reference(ctx, cfg, arch, leaves, feed, prog, after,
               variants=("program",)) -> dict:
    """The first three steps again in the reference, from the same weights
    drawn anew, on the same batches with the same dropout draws; the
    readings of each of ``variants`` against it: "program" (what the
    window's object did), "control" (the reference in float8 in its
    place), "half" (the reference on the first half of each batch, its mean
    over those images)."""
    from h100_bench.check import train_readings
    from h100_bench.reference.model import train_steps

    dev = ctx.device
    W = harness.make_weights(leaves, ctx.seeds.weights, dev)
    seed = max(cfg.SEED, 0)

    def gens():
        return [torch.Generator(device=dev).manual_seed(
            ((seed & 0x7FFFFFFF) << 32) | (i & 0xFFFFFFFF))
            for i in range(CHECKED_STEPS)]

    batches = [{k: v.to(dev) for k, v in b.items()} for b in feed.kept]

    def steps(bs, precision="f32"):
        out = train_steps(arch, W, bs, gens(), ctx.solver(), precision)
        out["change"] = {n: float((p - W[n]).norm())
                         for n, p in out.pop("params").items()}
        return out

    ref = steps(batches)
    harness.log("reference steps done")
    readings = {}
    for v in variants:
        if v == "program":
            prog["change"] = {n: float((after[n].to(dev) - W[n]).norm())
                              for n in after}
            side = prog
        elif v == "control":
            side = steps(batches, "fp8")
        elif v == "half":
            side = steps([{k: t[:t.shape[0] // 2] for k, t in b.items()}
                          for b in batches])
        else:
            raise ValueError(v)
        readings[v] = train_readings(side, ref)
    return readings
