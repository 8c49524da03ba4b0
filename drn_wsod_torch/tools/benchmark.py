"""Time the train step, detection, the TTA protocol and the train loader
apart (counterpart of ``tools/benchmark.py``).

    python -m drn_wsod_torch.tools.benchmark --task train|eval|tta|data \\
        [--config-file CONFIG] [--batch 1] [--iters N] [KEY VALUE ...]

Without a config file the defaults' model runs; ``train``, ``eval`` and
``tta`` need no dataset (synthetic batches, seeded random weights),
``data`` reads ``DATASETS.TRAIN`` under ``$DETECTRON2_DATASETS``.

* ``train``: ``make_train_step`` on a synthetic batch of
  ``SOLVER.IMS_PER_BATCH`` 704x704 images with ``BATCH_SIZE_PER_IMAGE``
  proposals.
* ``eval``: ``make_detect_fn`` on a synthetic batch of ``--batch``.
* ``tta``: ``GeneralizedRCNNWithTTAAVG`` on one 500x375 record whose
  image is a JPEG file written by the port's encoder
  (``native.py:jpeg_encode``; the JAX tool writes it with Pillow), so
  the decode is timed as in evaluation.
* ``data``: batches of the train loader.

On the card the model tasks are timed with CUDA events around ``iters``
calls after one warm-up (the calls queue back to back; the events fence
once), ``data`` and every task on the CPU by the host clock. It prints
and returns its numbers; it is a tool, not a benchmark of record, and
writes no file of results.

It also holds what the probes of ``drn_wsod_torch/tools`` share: the
timers (:func:`timed_ms`, :func:`queued_ms`, :func:`sync`), the card's
tag (:func:`card_tag`), the seeded train step (:func:`seeded_train_step`)
and the probes' lr (``PROBE_LR``).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict

import numpy as np
import torch


# the lr of the probes that train for tens of steps (``tools/
# dispatch_probe.py``, ``scan_k_probe.py``, ``scan_variants_probe.py``,
# ``cli_throughput.py``): from random weights the flagship YAML's 0.01
# drives the losses to NaN within about 20 steps of one batch on an H100,
# and the Trainer's guard then stops the run. The lr is a scalar of the
# update: it changes no launch and no shape.
PROBE_LR = ("SOLVER.BASE_LR", "1e-4")


def timed_ms(fn: Callable[[], object], iters: int, dev: torch.device
             ) -> float:
    """ms per call of ``fn``: one warm-up call, then ``iters`` calls, by
    CUDA events on the card and by the host clock elsewhere."""
    fn()
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work where ``dev`` is CUDA (the host
    clock's fence); nothing elsewhere."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def card_tag(dev: torch.device) -> str:
    """"[name, power limit]" of the card as nvidia-smi reports them where
    ``dev`` is CUDA, else "[cpu]": the tag every probe line carries."""
    from .ablate_bench import card

    return f"[{card()}]" if torch.device(dev).type == "cuda" else "[cpu]"


def queued_ms(fn: Callable[[], object], calls: int = 20,
              dev: torch.device | str | None = None) -> float:
    """Device ms per call of ``fn`` with its host issue hidden ("queued"):
    after a warm-up call, ``calls`` calls are queued behind a sleep of
    about 50 ms on the stream, so the card runs them back to back; CUDA
    events around the calls. For work that takes the host about as long
    to issue as the card to run. ``dev`` None is the card; on another
    device this is :func:`timed_ms`, the host clock."""
    if dev is not None and torch.device(dev).type != "cuda":
        return timed_ms(fn, calls, torch.device(dev))
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


def _model(cfg, dev):
    from ..models import build_model

    gen = torch.Generator(device=dev).manual_seed(0)
    return build_model(cfg, device=dev, generator=gen)


def seeded_train_step(cfg, dev):
    """``(step, state)``: ``make_train_step`` of the config's model from
    seeded random weights and its optimizer state; a call updates the
    state in place."""
    from ..engine import create_train_state, make_train_step
    from ..solver import build_optimizer

    model = _model(cfg, dev)
    tx = build_optimizer(cfg, model)
    return make_train_step(model, tx), create_train_state(model, tx)


def benchmark_train_synthetic(cfg, iters: int = 20, device=None,
                              size: int = 704) -> Dict[str, float]:
    from ..device import resolve_device
    from ..synthetic import synthetic_batch

    dev = resolve_device(device)
    B = max(cfg.SOLVER.IMS_PER_BATCH, 1)
    step, state = seeded_train_step(cfg, dev)
    batch = synthetic_batch(B, size, size,
                            cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
                            cfg.MODEL.ROI_HEADS.NUM_CLASSES, device=dev)
    ms = timed_ms(lambda: step(state, batch, 0), iters, dev)
    out = {"ms_per_iter": ms, "img_per_s": B * 1e3 / ms}
    print(f"train: {ms:.1f} ms/iter, {out['img_per_s']:.2f} img/s")
    return out


def benchmark_eval_synthetic(cfg, iters: int = 20, batch_size: int = 1,
                             device=None, size: int = 704
                             ) -> Dict[str, float]:
    from ..device import resolve_device
    from ..evaluation import make_detect_fn
    from ..synthetic import synthetic_batch

    dev = resolve_device(device)
    model = _model(cfg, dev)
    batch = synthetic_batch(batch_size, size, size,
                            cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
                            cfg.MODEL.ROI_HEADS.NUM_CLASSES, device=dev)
    detect = make_detect_fn(model, cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
                            cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
                            cfg.TEST.DETECTIONS_PER_IMAGE, device=dev)
    ms = timed_ms(lambda: detect(batch), iters, dev) / batch_size
    out = {"ms_per_img": ms, "img_per_s": 1e3 / ms}
    print(f"eval (B={batch_size}): {ms:.1f} ms/img, "
          f"{out['img_per_s']:.2f} img/s")
    return out


def benchmark_tta_synthetic(cfg, iters: int = 10, device=None
                            ) -> Dict[str, float]:
    """The TTA-AVG protocol (``TEST.AUG.MIN_SIZES`` x flip) on a
    500x375 JPEG record with ``BATCH_SIZE_PER_IMAGE`` proposals."""
    from ..device import resolve_device
    from ..native import jpeg_encode
    from ..tta import GeneralizedRCNNWithTTAAVG

    dev = resolve_device(device)
    P = cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    tta = GeneralizedRCNNWithTTAAVG(cfg, _model(cfg, dev), device=dev)
    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, (375, 500, 3), dtype=np.uint8)
    fd, path = tempfile.mkstemp(suffix=".jpg")
    with os.fdopen(fd, "wb") as f:
        f.write(jpeg_encode(img))
    x1 = rs.uniform(0, 400, P).astype(np.float32)
    y1 = rs.uniform(0, 300, P).astype(np.float32)
    w = rs.uniform(8, 100, P).astype(np.float32)
    h = rs.uniform(8, 75, P).astype(np.float32)
    record = {
        "file_name": path,
        "proposal_boxes": np.stack([x1, y1, x1 + w, y1 + h], 1),
        "proposal_objectness_logits": rs.uniform(0, 1, P).astype(np.float32),
        "annotations": [{"category_id": 3}],
        "height": 375, "width": 500,
    }
    n_views = len(cfg.TEST.AUG.MIN_SIZES) * (2 if cfg.TEST.AUG.FLIP else 1)
    try:
        # the record's outputs come back to the host each call
        ms = timed_ms(lambda: tta(record), iters, torch.device("cpu"))
    finally:
        os.unlink(path)
    out = {"ms_per_img": ms, "img_per_s": 1e3 / ms, "views": n_views}
    print(f"tta ({n_views} views, P={P}): {ms:.1f} ms/img, "
          f"{out['img_per_s']:.2f} img/s")
    return out


def benchmark_data(cfg, iters: int = 100) -> Dict[str, float]:
    from ..data import DatasetMapper, build_detection_train_loader
    from ..data.datasets.voc import register_all_pascal_voc

    register_all_pascal_voc(os.environ.get("DETECTRON2_DATASETS", "datasets"))
    loader = build_detection_train_loader(cfg, DatasetMapper(cfg, True))
    it = iter(loader)
    ms = timed_ms(lambda: next(it), iters, torch.device("cpu"))
    out = {"ms_per_batch": ms,
           "img_per_s": cfg.SOLVER.IMS_PER_BATCH * 1e3 / ms}
    print(f"data: {ms:.1f} ms/batch, {out['img_per_s']:.1f} img/s")
    return out


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch benchmark")
    p.add_argument("--task", default="train",
                   choices=["train", "eval", "tta", "data"])
    p.add_argument("--config-file", default="")
    p.add_argument("--batch", type=int, default=1,
                   help="images per eval batch (eval task)")
    p.add_argument("--iters", type=int, default=0)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None, device=None) -> Dict[str, float]:
    from ..config import get_cfg

    args = argument_parser().parse_args(argv)
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    kw = {"iters": args.iters} if args.iters else {}
    if args.task == "train":
        return benchmark_train_synthetic(cfg, device=device, **kw)
    if args.task == "eval":
        return benchmark_eval_synthetic(cfg, batch_size=args.batch,
                                        device=device, **kw)
    if args.task == "tta":
        return benchmark_tta_synthetic(cfg, device=device, **kw)
    return benchmark_data(cfg, **kw)


if __name__ == "__main__":
    main()
