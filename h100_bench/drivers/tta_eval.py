"""The TTA evaluation cell: the program's
``tta.py:GeneralizedRCNNWithTTAAVG.__call__`` on packed records, one image
after another, each image's detections handed to the VOC evaluator's
``process_single``, as ``tools/train_net.py:_do_test`` does.

Set-up: the records drawn from the seed and held packed (decoded pixels) in
memory; the model built with the benchmark's weights; one image of every
(bucket, views) group the records produce, run once. The window: images in
the records' order until ``seconds`` have passed; each image's time is the
host clock from the call to its detections as numpy arrays. The final
``evaluate()`` lies outside the window and is not run.
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench import harness
from h100_bench.flops import image_flops
from h100_bench.reference import arch as arch_lib
from h100_bench.reference import model as ref_model
from h100_bench.traffic.generate import make_records
from h100_bench.yardstick import view_groups

SAMPLE = 6       # images the reference checks, the largest among them


def _groups(cfg, hw):
    aug = cfg.TEST.AUG
    return view_groups(hw, tuple(aug.MIN_SIZES), aug.MAX_SIZE, aug.FLIP,
                       tuple(cfg.INPUT.BUCKETS))


def _n_valid(record, P):
    keep = ref_model.ops.unique_boxes_mask(
        np.asarray(record["proposal_boxes"], np.float32))
    return min(int(keep.sum()), P)


def run(ctx) -> dict:
    from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES
    from drn_wsod_torch.evaluation import PascalVOCDetectionEvaluator
    from drn_wsod_torch.models import build_model
    from drn_wsod_torch.tta import GeneralizedRCNNWithTTAAVG

    dev, seeds = ctx.device, ctx.seeds
    arch = arch_lib.from_config(ctx.conf["merged"])
    cfg = ctx.program_cfg()
    records = make_records(ctx.mix, seeds.traffic, dev, ctx.n_records)
    leaves = arch_lib.leaves(arch)
    W = harness.make_weights(leaves, seeds.weights, dev)
    model = build_model(cfg, device=dev)
    harness.load_into(model, W)
    del W
    tta = GeneralizedRCNNWithTTAAVG(cfg, model, device=dev)
    harness.log(f"{len(records)} records and the model ready")
    evaluator = PascalVOCDetectionEvaluator(
        VOC_CLASS_NAMES, {r["image_id"]: r["annotations"] for r in records},
        year=2007)
    evaluator.reset()
    seen = set()
    for r in records:
        sig = {(b, len(v))
               for b, v in _groups(cfg, (r["height"], r["width"])).items()}
        if sig - seen:
            tta(r)
            seen |= sig
    harness.sync(dev)
    harness.log(f"{len(seen)} bucket groups warmed")

    done = []          # (record index, seconds, detections)

    def image(i):
        r = records[i % len(records)]
        t = harness.now()
        dets = tta(r)
        t = harness.now() - t
        evaluator.process_single(r["image_id"], dets["boxes"], dets["scores"],
                                 dets["classes"], dets["valid"])
        done.append((i % len(records), t, dets))

    out = {"groups_warmed": len(seen)}
    if ctx.checks_only:
        out["setup_s"] = harness.process_age_s()
        for i in range(SAMPLE + 2):
            image(i)
    elif not ctx.trace:
        t0 = harness.now()
        out["setup_s"] = harness.process_age_s()
        host0 = harness.host_sample()
        while harness.now() - t0 < ctx.seconds:
            image(len(done))
        secs = harness.now() - t0
        out["host"] = harness.host_load(host0, harness.host_sample())
        times = [t for _, t, _ in done]
        out["metrics"] = {"eval_img_s": len(done) / secs,
                          "eval_p90_ms": harness.percentile(times, 90) * 1e3}
        out.update(window_s=secs, images=len(done))
    else:
        out["setup_s"] = harness.process_age_s()
        out.update(_traced(ctx, cfg, arch, records, image, done, dev))
    harness.log(f"window closed after {len(done)} images")
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["attempted"], out["failed"] = len(done), 0
    del tta, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["reference"] = lambda variants=("program",): _reference(
        ctx, cfg, arch, leaves, records, done, variants)
    return out


def _traced(ctx, cfg, arch, records, image, done, dev) -> dict:
    """An untraced sub-window of a quarter of ``seconds``, then a traced
    one over as many images."""
    from h100_bench.trace import traced

    P = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    t0 = harness.now()
    while harness.now() - t0 < max(ctx.seconds / 4.0, 1.0):
        image(len(done))
    secs = harness.now() - t0
    n = len(done)
    flops = 0
    for i, _, _ in done:
        r = records[i]
        nv = _n_valid(r, P)
        for views in _groups(cfg, (r["height"], r["width"])).values():
            flops += sum(image_flops(arch, nh, nw, nv, False)
                         for nh, nw, _ in views)

    def more():
        for _ in range(n):
            image(len(done))

    _, tr = traced(more, lambda: harness.sync(dev))
    harness.log(f"{len(tr.device)} device events read")
    k1 = []
    for i, _, _ in done[n:]:
        r = records[i]
        inputs = ref_model.tta_inputs(r["image"], r, P, dev)
        for bucket, views in _groups(cfg, (r["height"], r["width"])).items():
            boxes, _ = ref_model.view_boxes(
                inputs["hw0"], [(h, w) for h, w, _ in views],
                [f for _, _, f in views], inputs["boxes"], inputs["mask"])
            k1.append({"batch": len(views), "map": arch.feature_size(bucket),
                       "dtype": ctx.conf["merged"]["MODEL"]["DTYPE"],
                       "boxes": boxes, "channels": arch.out_channels,
                       "resolution": arch.resolution,
                       "spatial_scale": 1.0 / arch.feature_stride})
    return {"kind": "eval", "untraced_n": n, "untraced_s": secs,
            "flops": flops, "trace": tr, "traced_n": n, "k1_calls": k1}


def _reference(ctx, cfg, arch, leaves, records, done,
               variants=("program",)) -> dict:
    """The reference's detections of a sample of the finished images (the
    largest among them), and its NMS over each side's own matrices; the
    readings of each of ``variants``: "program" (what the window
    produced), "control" (the reference in float8 in its place), "half"
    (the reference's mean over every other view), "altered" (the program's
    answer with its first detection's class changed)."""
    from h100_bench.check import tta_readings
    from h100_bench.reference.model import Reference

    dev = ctx.device
    rng = np.random.default_rng(ctx.seeds.sample)
    size = [records[i]["height"] * records[i]["width"] for i, _, _ in done]
    largest = int(np.argmax(size))
    rest = [j for j in range(len(done)) if j != largest]
    pick = [largest] + [int(j) for j in rng.choice(
        rest, size=min(SAMPLE - 1, len(rest)), replace=False)]
    W = harness.make_weights(leaves, ctx.seeds.weights, dev)
    rh = cfg.MODEL.ROI_HEADS
    P, C = rh.BATCH_SIZE_PER_IMAGE, rh.NUM_CLASSES
    finish = (rh.NMS_THRESH_TEST, rh.SCORE_THRESH_TEST,
              cfg.TEST.DETECTIONS_PER_IMAGE)

    def nms_of(dets, mask):
        with ref_model.ops.full_float32():
            mine = ref_model.ops.multiclass_nms(
                torch.from_numpy(dets["all_boxes"]).to(dev)[None],
                torch.from_numpy(dets["all_scores"][:, :C]).to(dev)[None],
                mask[None], *finish)
        return {k: v[0].cpu().numpy() for k, v in mine.items()}

    sides = {v: ([], []) for v in variants}
    refs = []
    for j in pick:
        i, _, dets = done[j]
        r = records[i]
        inputs = ref_model.tta_inputs(r["image"], r, P, dev)
        groups = _groups(cfg, (r["height"], r["width"]))

        def detect(precision="f32", views=None):
            s, b, n = ref_model.tta_sums(Reference(arch, W, precision),
                                         inputs, groups, views)
            return ref_model.tta_finish(s, b, n, inputs["mask"], *finish)

        refs.append(detect())
        for v in variants:
            if v == "program":
                side = dets
            elif v == "control":
                side = detect("fp8")
            elif v == "half":
                n = sum(len(g) for g in groups.values())
                side = detect(views=set(range(0, n, 2)))
            elif v == "altered":
                side = {k: a.copy() for k, a in dets.items()}
                side["classes"][0] = (side["classes"][0] + 1) % C
            else:
                raise ValueError(v)
            sides[v][0].append(side)
            sides[v][1].append(nms_of(side, inputs["mask"]))
    readings = {}
    for v in variants:
        readings[v] = tta_readings(sides[v][0], refs, sides[v][1])
        readings[v]["_sample"] = [done[j][0] for j in pick]
    return readings
