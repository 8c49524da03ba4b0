"""Single-image WSOD demo on ``DefaultPredictor`` (counterpart of
``demo/demo.py``). WSOD consumes precomputed proposals, so the demo takes a
proposal pickle beside the image(s); without one it falls back to a coarse
multi-scale window grid so that the pipeline still runs.

    python -m drn_wsod_torch.tools.demo --config-file CONFIG \\
        --input IMAGE [IMAGE ...] [--proposals PKL] [KEY VALUE ...]

Prints each detection above ``--confidence-threshold`` as
``class  score  [x1, y1, x2, y2]`` and a count per image. Several inputs
are the frames of a sequence (frame i takes the pickle's i-th image, the
last one past its end). ``--output`` writes the annotated images
(``utils/visualizer.py``; a sequence through ``utils/video_visualizer.py``,
whose colours follow each object across frames): to that file for one
input, else into that directory under each input's basename, as PNG or
JPEG by the name's extension (``Visualizer.save``; another extension
raises). Runs on the CUDA device.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def grid_proposals(h: int, w: int, n_scales: int = 4) -> np.ndarray:
    """Square windows at ``n_scales`` sizes (the shorter side halved each
    time, down to 16), strided by half a window: a proposal fallback."""
    boxes = []
    for s in range(n_scales):
        size = min(h, w) // (2 ** s)
        if size < 16:
            break
        step = max(size // 2, 8)
        for y in range(0, h - size + 1, step):
            for x in range(0, w - size + 1, step):
                boxes.append([x, y, x + size, y + size])
    return np.asarray(boxes, dtype=np.float32).reshape(-1, 4)


def frame_proposals(data, fi: int):
    """Frame ``fi``'s (boxes, objectness) from a proposal pickle.

    Accepts {"boxes": [per-image (Ni, 4)], "objectness_logits" or the
    legacy "scores": [per-image (Ni,)]}, the single-image shorthand
    {"boxes": (N, 4), "scores": (N,)} (a 2-D array is one image's boxes,
    not a list of images), and a root that is no dict: a bare (N, 4) array
    or a per-image list of boxes, without objectness. The JAX package's
    demo raises on such a root (``demo/demo.py:41-48``: ValueError for an
    array, AttributeError for a list); the port takes it."""
    if not isinstance(data, dict):
        data = {"boxes": data}
    raw = data["boxes"]
    if isinstance(raw, np.ndarray) and raw.ndim == 2:
        raw = [raw]
    boxes = np.asarray(raw[min(fi, len(raw) - 1)],
                       dtype=np.float32).reshape(-1, 4)
    obj = data.get("objectness_logits", data.get("scores"))
    if obj is None:
        obj = [np.zeros(len(boxes))]
    if isinstance(obj, np.ndarray) and obj.ndim == 1:
        obj = [obj]
    objectness = np.asarray(obj[min(fi, len(obj) - 1)], dtype=np.float32)
    return boxes, objectness


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch demo")
    p.add_argument("--config-file", required=True)
    p.add_argument("--input", required=True, nargs="+",
                   help="image path(s); several are the frames of a "
                        "sequence")
    p.add_argument("--output", default="",
                   help="file (single input) or directory to write "
                        "annotated images")
    p.add_argument("--proposals", default="",
                   help="a proposal pickle (trusted: unpickling runs code)")
    p.add_argument("--confidence-threshold", type=float, default=0.3)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None, device=None) -> int:
    """Run the demo; returns the number of detections printed."""
    from ..config import get_cfg
    from ..data.datasets.voc import VOC_CLASS_NAMES
    from ..data.mapper import read_image
    from ..engine.defaults import DefaultPredictor
    from ..utils.video_visualizer import VideoVisualizer
    from ..utils.visualizer import Visualizer, save_image

    args = argument_parser().parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)

    proposal_data = None
    if args.proposals:
        with open(args.proposals, "rb") as f:
            proposal_data = pickle.load(f)

    predictor = DefaultPredictor(cfg, device=device)
    names = (VOC_CLASS_NAMES if cfg.MODEL.ROI_HEADS.NUM_CLASSES == 20
             else [str(i) for i in range(cfg.MODEL.ROI_HEADS.NUM_CLASSES)])
    is_sequence = len(args.input) > 1
    video_vis = (VideoVisualizer(names) if is_sequence and args.output
                 else None)
    total = 0
    for fi, path in enumerate(args.input):
        image = read_image(path, cfg.INPUT.FORMAT)
        if proposal_data is not None:
            boxes, objectness = frame_proposals(proposal_data, fi)
        else:
            boxes = grid_proposals(*image.shape[:2])
            objectness = np.zeros(len(boxes), dtype=np.float32)

        out = predictor(image, boxes, objectness)
        n = 0
        for box, score, cls in zip(out["boxes"], out["scores"],
                                   out["classes"]):
            if score < args.confidence_threshold:
                continue
            n += 1
            print(f"{names[int(cls)]:>14s}  {score:.3f}  "
                  f"[{box[0]:.0f}, {box[1]:.0f}, "
                  f"{box[2]:.0f}, {box[3]:.0f}]")
        print(f"{path}: {n} detections above {args.confidence_threshold}")
        total += n

        if args.output:
            if video_vis is not None:
                vis = video_vis.draw_frame(
                    image, out["boxes"], out["scores"], out["classes"],
                    score_thresh=args.confidence_threshold)
            else:
                vis = Visualizer(image, names).draw_instance_predictions(
                    out["boxes"], out["scores"], out["classes"],
                    score_thresh=args.confidence_threshold).get_image()
            if is_sequence or os.path.isdir(args.output):
                dst = os.path.join(args.output, os.path.basename(path))
            else:
                dst = args.output
            save_image(dst, vis)
    return total


if __name__ == "__main__":
    main()
