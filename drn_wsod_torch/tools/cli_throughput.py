"""img/s of the shipped training CLI at the bench shape (counterpart of
the JAX package's ``tools/cli_throughput.py``).

    python -m drn_wsod_torch.tools.cli_throughput [--iters 80]
        [--images 48] [--root DIR] [--size 500] [--proposals 4096]
        [--config-file CONFIG] [KEY VALUE ...]

``tools/benchmark.py`` and ``dispatch_probe`` time the step alone; this
runs the port's ``tools/train_net.py:main`` itself (the loader and its
prefetch, the hooks, the writers, the chunked steps) on a synthetic VOC
tree written under ``--root`` (default ``build/cli_throughput`` in the
checkout; its ``VOC2007`` and ``out`` are rewritten each run): square
500 px JPEGs written by the port's encoder (``native.jpeg_encode``), one
annotated object each, 4096
proposals an image in a Detectron2 pickle, registered as
``cli_throughput_train``. The flagship YAML from seeded random weights
with ``MIN_SIZE_TRAIN (688,)`` and no crop, so every image lands in the
704 bucket; B=2 (the bench's), ``benchmark.PROBE_LR``, no evaluation, no
TTA.
``SOLVER.STEPS_PER_DISPATCH`` and the hook periods give the chunk K
(``train_net.steps_per_dispatch``). It reads the fenced seconds a step
that ``IterationTimer`` publishes as ``time`` from ``metrics.json``,
leaves out the first chunk (iterations below K) and the writers' repeat
of the last window after training, and prints one JSON line with the JAX
tool's keys: the median's img/s as ``value``, the mean's as
``mean_img_s``, every window, and ``vs_baseline``, the ratio to 42.1 / 8
img/s a card (the reference's eight-V100 figure, ``bench.py``).
"""

from __future__ import annotations

import argparse
import json
import pickle
import shutil
from pathlib import Path

import numpy as np

from .benchmark import PROBE_LR

DATASET = "cli_throughput_train"
CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle")
DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "cli_throughput"


def make_dataset(root: Path, n_images: int, size: int, n_prop: int) -> str:
    """The VOC tree of the JAX tool's draws (``RandomState(0)``: pixels,
    the object's box, then the proposals and their objectness, image by
    image) under ``root/VOC2007``; returns the proposal file's path."""
    from drn_wsod_torch.native import jpeg_encode

    rng = np.random.RandomState(0)
    d = root / "VOC2007"
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    ids, boxes_all, logits_all = [], [], []
    for i in range(n_images):
        name = f"im{i:04d}"
        ids.append(name)
        img = rng.randint(0, 255, (size, size, 3), dtype=np.uint8)
        (d / "JPEGImages" / f"{name}.jpg").write_bytes(jpeg_encode(img))
        x1, y1 = rng.randint(5, size // 3, 2)
        x2 = x1 + rng.randint(40, size // 2)
        y2 = y1 + rng.randint(40, size // 2)
        (d / "Annotations" / f"{name}.xml").write_text(
            f"<annotation><size><width>{size}</width>"
            f"<height>{size}</height><depth>3</depth></size>"
            f"<object><name>{CLASSES[i % len(CLASSES)]}</name>"
            f"<difficult>0</difficult><bndbox><xmin>{x1}</xmin>"
            f"<ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox>"
            f"</object></annotation>")
        px1 = rng.uniform(0, size * 0.8, n_prop)
        py1 = rng.uniform(0, size * 0.8, n_prop)
        pw = rng.uniform(8, size * 0.6, n_prop)
        ph = rng.uniform(8, size * 0.6, n_prop)
        boxes_all.append(np.stack(
            [px1, py1, np.minimum(px1 + pw, size - 1),
             np.minimum(py1 + ph, size - 1)], 1).astype(np.float32))
        logits_all.append(rng.uniform(0, 1, n_prop).astype(np.float32))
    (d / "ImageSets" / "Main" / "train.txt").write_text("\n".join(ids) + "\n")
    prop_file = root / "props.pkl"
    with open(prop_file, "wb") as f:
        pickle.dump({"ids": ids, "boxes": boxes_all,
                     "objectness_logits": logits_all, "bbox_mode": 0}, f)
    return str(prop_file)


def train_opts(prop_file: str, out_dir: str, iters: int) -> list:
    """The JAX tool's YAML overrides, as ``KEY VALUE`` pairs, and
    ``benchmark.PROBE_LR``."""
    return ["MODEL.WEIGHTS", "", "DATASETS.TRAIN", f"('{DATASET}',)",
            "DATASETS.PROPOSAL_FILES_TRAIN", f"('{prop_file}',)",
            "DATASETS.TEST", "()", "INPUT.MIN_SIZE_TRAIN", "(688,)",
            "INPUT.CROP.ENABLED", "False", "SOLVER.IMS_PER_BATCH", "2",
            "SOLVER.MAX_ITER", str(iters), "SOLVER.STEPS", f"({iters - 1},)",
            "SOLVER.CHECKPOINT_PERIOD", str(iters), "TEST.EVAL_PERIOD", "0",
            "TEST.EVAL_TRAIN", "False", "TEST.AUG.ENABLED", "False",
            "VIS_PERIOD", "0", "OUTPUT_DIR", out_dir, *PROBE_LR]


def run(iters: int = 80, images: int = 48, root: Path = DEFAULT_ROOT,
        size: int = 500, proposals: int = 4096, config_file: str = "",
        opts=(), device=None) -> dict:
    """Write the tree, train through ``train_net.main``, read the windows.
    Returns the JSON line's object."""
    from drn_wsod_torch import get_cfg
    from drn_wsod_torch.data import DatasetCatalog, MetadataCatalog
    from drn_wsod_torch.data.datasets.voc import register_pascal_voc
    from drn_wsod_torch.engine.defaults import default_argument_parser
    from drn_wsod_torch.tools import train_net
    from drn_wsod_torch.tools.ablate_bench import FLAGSHIP

    root = Path(root)
    for sub in ("VOC2007", "out"):
        shutil.rmtree(root / sub, ignore_errors=True)
    prop_file = make_dataset(root, images, size, proposals)
    out_dir = root / "out"
    argv = ["--config-file", config_file or FLAGSHIP,
            *train_opts(prop_file, str(out_dir), iters), *opts]
    args = default_argument_parser().parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    k = train_net.steps_per_dispatch(cfg)
    B = cfg.SOLVER.IMS_PER_BATCH

    if DATASET in DatasetCatalog:
        DatasetCatalog.remove(DATASET)
    register_pascal_voc(DATASET, str(root / "VOC2007"), "train", 2007)
    try:
        train_net.main(args, device=device)
    finally:
        DatasetCatalog.remove(DATASET)
        MetadataCatalog._map.pop(DATASET, None)
    # the writers write once more after training, at iteration MAX_ITER,
    # the last chunk's time again: not a window of its own
    times = []
    with open(out_dir / "metrics.json") as f:
        for line in f:
            rec = json.loads(line)
            if "time" in rec and k <= rec.get("iteration", 0) < iters:
                times.append(float(rec["time"]))
    if not times:
        raise RuntimeError(f"no 'time' recorded past the first chunk of "
                           f"{k} steps in {iters} iterations")
    sec_med, sec_mean = float(np.median(times)), float(np.mean(times))
    return {"metric": "cli_trainer_images_per_sec_per_chip",
            "value": B / sec_med, "unit": "img/s/chip",
            "sec_per_iter_median": sec_med, "sec_per_iter_mean": sec_mean,
            "sec_per_iter_windows": times, "mean_img_s": B / sec_mean,
            "vs_baseline": B / sec_med / (42.1 / 8),
            "steps_per_dispatch": k, "iters": iters, "images": images}


def main(argv=None, device=None) -> dict:
    from drn_wsod_torch.device import resolve_device
    from drn_wsod_torch.tools.benchmark import card_tag

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=80)
    ap.add_argument("--images", type=int, default=48)
    ap.add_argument("--root", default=str(DEFAULT_ROOT))
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--proposals", type=int, default=4096)
    ap.add_argument("--config-file", default="")
    ap.add_argument("opts", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    result = run(args.iters, args.images, Path(args.root), args.size,
                 args.proposals, args.config_file, args.opts, dev)
    result["card"] = card_tag(dev)[1:-1]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
