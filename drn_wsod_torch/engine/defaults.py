"""Default setup and the predictors (counterpart of
``drn_wsod_tpu/engine/defaults.py``): the argument parser, logging, the
run's set-up (output directory, seed, ``config.yaml``), the worker-count
rescaling of a config, ``DefaultPredictor`` (one image and its proposals ->
detections in the image's frame) and ``AsyncPredictor`` (the same on a
worker thread, results in submission order)."""

from __future__ import annotations

import argparse
import logging
import os
import queue
import sys
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device

logger = logging.getLogger(__name__)


def default_argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="drn_wsod_torch training and evaluation")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint under "
                             "OUTPUT_DIR/checkpoints")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="dotted-key config overrides")
    return parser


def setup_logger(output_dir: Optional[str] = None,
                 name: str = "drn_wsod_torch",
                 distributed_rank: int = 0) -> logging.Logger:
    """INFO logging to standard output and, with ``output_dir``, to
    ``output_dir/log.txt``; a rank other than 0 logs to its own
    ``log.txt.rank{r}`` only."""
    fmt = "[%(asctime)s %(name)s]: %(message)s"
    handlers = ([logging.StreamHandler(sys.stdout)]
                if distributed_rank == 0 else [])
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fname = "log.txt" if distributed_rank == 0 else \
            f"log.txt.rank{distributed_rank}"
        handlers.append(logging.FileHandler(os.path.join(output_dir, fname)))
    logging.basicConfig(level=logging.INFO, format=fmt, handlers=handlers,
                        force=True)
    return logging.getLogger(name)


def auto_scale_workers(cfg, num_workers: int):
    """Rescale batch size, LR and schedule to ``num_workers`` devices so
    that the per-device batch stays what ``SOLVER.REFERENCE_WORLD_SIZE``
    defined (LR linear in the batch, iteration counts inverse). Returns cfg
    itself when REFERENCE_WORLD_SIZE is 0 or already ``num_workers``."""
    old = cfg.SOLVER.REFERENCE_WORLD_SIZE
    if old == 0 or old == num_workers:
        return cfg
    if cfg.SOLVER.IMS_PER_BATCH % old:
        raise ValueError("Invalid REFERENCE_WORLD_SIZE in config!")
    frozen = cfg.is_frozen()
    cfg = cfg.clone()
    cfg.defrost()
    scale = num_workers / old
    cfg.SOLVER.IMS_PER_BATCH = int(round(cfg.SOLVER.IMS_PER_BATCH * scale))
    cfg.SOLVER.BASE_LR = cfg.SOLVER.BASE_LR * scale
    cfg.SOLVER.MAX_ITER = int(round(cfg.SOLVER.MAX_ITER / scale))
    cfg.SOLVER.WARMUP_ITERS = int(round(cfg.SOLVER.WARMUP_ITERS / scale))
    cfg.SOLVER.STEPS = tuple(int(round(s / scale))
                             for s in cfg.SOLVER.STEPS)
    cfg.TEST.EVAL_PERIOD = int(round(cfg.TEST.EVAL_PERIOD / scale))
    cfg.SOLVER.REFERENCE_WORLD_SIZE = num_workers
    logger.info(
        "Auto-scaled config to batch_size=%d, lr=%g, max_iter=%d, warmup=%d",
        cfg.SOLVER.IMS_PER_BATCH, cfg.SOLVER.BASE_LR, cfg.SOLVER.MAX_ITER,
        cfg.SOLVER.WARMUP_ITERS)
    if frozen:
        cfg.freeze()
    return cfg


def default_setup(cfg, args=None) -> int:
    """Create ``OUTPUT_DIR``, set up logging (per rank over several
    processes), seed numpy and torch from ``SEED`` (a random seed where it
    is negative) and write the config to
    ``OUTPUT_DIR/config.yaml`` (rank 0 alone). Returns the seed."""
    from ..parallel import multihost

    rank = multihost.get_rank()
    output_dir = cfg.OUTPUT_DIR
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    setup_logger(output_dir, distributed_rank=rank)
    logger.info(f"Rank {rank} of {multihost.get_world_size()}")
    seed = (cfg.SEED if cfg.SEED >= 0
            else int.from_bytes(os.urandom(4), "little") & 0x7FFFFFFF)
    np.random.seed(seed)
    torch.manual_seed(seed)
    devices = ([torch.cuda.get_device_name(i)
                for i in range(torch.cuda.device_count())]
               if torch.cuda.is_available() else ["cpu"])
    logger.info(f"Seed: {seed}; devices: {devices}")
    if output_dir and rank == 0:
        with open(os.path.join(output_dir, "config.yaml"), "w") as f:
            f.write(cfg.dump())
    return seed


class DefaultPredictor:
    """Single-image inference: a raw image in ``INPUT.FORMAT`` channel
    order and its precomputed proposals (WSOD has no proposal network) ->
    detections in the image's own frame, after the test resize, on
    ``device`` (CUDA unless the caller names another one; raises where CUDA
    is absent). ``model`` defaults to the configured model with
    ``MODEL.WEIGHTS`` loaded where set."""

    def __init__(self, cfg, model=None, device=None):
        from ..checkpoint import load_reference_weights
        from ..data.mapper import DatasetMapper
        from ..evaluation.evaluator import make_detect_fn
        from ..models import build_model

        self.cfg = cfg.clone()
        self.device = resolve_device(device)
        if model is None:
            model = build_model(cfg, device=self.device)
            if cfg.MODEL.WEIGHTS:
                load_reference_weights(cfg.MODEL.WEIGHTS, model)
        self.model = model
        self.mapper = DatasetMapper(cfg, is_train=False)
        self._detect = make_detect_fn(
            model, cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
            cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
            cfg.TEST.DETECTIONS_PER_IMAGE, device=self.device)

    def __call__(self, original_image: np.ndarray, proposal_boxes: np.ndarray,
                 objectness: Optional[np.ndarray] = None
                 ) -> Dict[str, np.ndarray]:
        """original_image: (H, W, 3); proposal_boxes: (N, 4) XYXY in its
        frame, by descending objectness. Returns the valid detections'
        "boxes" (D, 4), "scores" (D,) and "classes" (D,)."""
        from ..data import transforms as T
        from ..data.loader import _collate
        from ..data.mapper import pick_bucket
        from ..data.proposals import transform_proposals

        record = {
            "proposal_boxes": proposal_boxes,
            "proposal_objectness_logits":
                objectness if objectness is not None
                else np.zeros(len(proposal_boxes), np.float32),
        }
        rng = np.random.RandomState(0)
        h, w = original_image.shape[:2]
        image, tfms = T.apply_augmentations(self.mapper.augmentations,
                                            original_image, rng)
        nh, nw = image.shape[:2]
        boxes, logits = transform_proposals(record, (nh, nw), tfms,
                                            topk=self.mapper.topk)
        P = self.mapper.num_proposals
        n = min(len(boxes), P)
        bucket = pick_bucket(nh, nw, self.mapper.buckets)
        canvas = np.zeros((bucket, bucket, 3), dtype=(
            np.uint8 if image.dtype == np.uint8 else np.float32))
        canvas[:nh, :nw] = image
        sample = {
            "image": canvas,
            "image_hw": np.asarray([nh, nw], np.int32),
            "orig_hw": np.asarray([h, w], np.int32),
            "proposals": np.zeros((P, 4), np.float32),
            "proposal_mask": np.zeros((P,), bool),
            "objectness": np.zeros((P,), np.float32),
            "labels": np.zeros((self.mapper.num_classes,), np.float32),
            "image_id": np.asarray(0, np.int32),
        }
        sample["proposals"][:n] = boxes[:n]
        sample["objectness"][:n] = logits[:n]
        sample["proposal_mask"][:n] = True
        dets = self._detect(_collate([sample]))
        host = {k: dets[k][0].cpu().numpy()
                for k in ("boxes", "scores", "classes", "valid")}
        keep = host["valid"]
        return {k: host[k][keep] for k in ("boxes", "scores", "classes")}


class AsyncPredictor:
    """A :class:`DefaultPredictor` on a worker thread: ``put`` queues an
    input, ``get`` returns the next result in the order put (an exception
    raised for an input is raised by its ``get``). A thread, not a process
    pool: the card runs the work, and the host thread only issues it."""

    def __init__(self, cfg, model=None, queue_depth: int = 3, device=None):
        self._pred = DefaultPredictor(cfg, model, device=device)
        self._tasks: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._results: "queue.Queue" = queue.Queue()

        def worker():
            while True:
                item = self._tasks.get()
                if item is None:
                    return
                try:
                    self._results.put(self._pred(*item))
                except Exception as e:  # noqa: BLE001 - raised by get()
                    self._results.put(e)

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="async-predictor")
        self._thread.start()

    def put(self, image, proposal_boxes, objectness=None):
        self._tasks.put((image, proposal_boxes, objectness))

    def get(self):
        out = self._results.get()
        if isinstance(out, Exception):
            raise out
        return out

    def __call__(self, image, proposal_boxes, objectness=None):
        self.put(image, proposal_boxes, objectness)
        return self.get()

    def shutdown(self):
        self._tasks.put(None)
        self._thread.join()
