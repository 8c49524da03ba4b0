"""Generate pseudo ground truth from a trained WSOD model (counterpart of
``tools/generate_pgt.py``): detect over the TRAIN datasets and write, for
each present image class, its top detection as a COCO-format instance
json that ``register_coco_instances`` and the supervised retraining YAMLs
train from.

    python -m drn_wsod_torch.tools.generate_pgt --config-file CONFIG \\
        --out datasets/pgt/voc07_trainval.json [--score-thresh 0.3] \\
        [KEY VALUE ...]

The weights are the latest checkpoint of the port under
``OUTPUT_DIR/checkpoints`` (its own ``torch.save`` files; the JAX tool
reads orbax), else ``MODEL.WEIGHTS`` (Detectron2 weights). Detection is
``make_detect_fn`` (K1 on the card) over the test mapper's batches of
one. As in the JAX tool, ``--per-class-top1`` is ``store_true`` with
``default=True``, so it is always on and the ``--score-thresh`` branch
never admits a second box of a class; category ids are written + 1.
Runs on the CUDA device unless ``main`` is given another one.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

logger = logging.getLogger("drn_wsod_torch")


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch generate_pgt")
    p.add_argument("--config-file", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--per-class-top1", action="store_true", default=True,
                   help="keep only the top box per present image class")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None, device=None) -> dict:
    """Write ``--out``; returns the COCO dict."""
    from ..checkpoint import Checkpointer
    from ..config import get_cfg
    from ..data import DatasetMapper, MetadataCatalog
    from ..data.datasets.voc import register_all_pascal_voc
    from ..data.loader import EvalLoader, get_detection_dataset_dicts
    from ..device import resolve_device
    from ..engine import create_train_state
    from ..engine.defaults import default_setup
    from ..evaluation import make_detect_fn
    from ..models import build_model
    from ..solver import build_optimizer

    args = argument_parser().parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    default_setup(cfg)
    register_all_pascal_voc(os.environ.get("DETECTRON2_DATASETS", "datasets"))

    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    state = create_train_state(model, build_optimizer(cfg, model))
    Checkpointer(os.path.join(cfg.OUTPUT_DIR, "checkpoints")).resume_or_load(
        state, cfg.MODEL.WEIGHTS, resume=True)

    detect = make_detect_fn(model, cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
                            cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
                            cfg.TEST.DETECTIONS_PER_IMAGE, device=dev)
    mapper = DatasetMapper(cfg, is_train=False)

    images, annotations = [], []
    ann_id = 1
    class_names = None
    for di, name in enumerate(cfg.DATASETS.TRAIN):
        class_names = MetadataCatalog.get(name).thing_classes
        pf = ([cfg.DATASETS.PROPOSAL_FILES_TRAIN[di]]
              if cfg.MODEL.LOAD_PROPOSALS else ())
        records = get_detection_dataset_dicts([name], pf, filter_empty=True)
        loader = EvalLoader(records, mapper, batch_size=1,
                            prefetch=cfg.DATALOADER.PREFETCH,
                            process_index=0, process_count=1)
        for batch, n_real in loader:
            dets = {k: v.cpu().numpy() for k, v in detect(batch).items()
                    if k in ("boxes", "scores", "classes", "valid")}
            ids = batch.image_id.numpy()
            for i in range(n_real):
                r = records[int(ids[i])]
                h, w = r.get("height", 0), r.get("width", 0)
                images.append({"id": len(images) + 1,
                               "file_name": os.path.basename(r["file_name"]),
                               "height": h, "width": w})
                img_id = len(images)
                present = {a["category_id"] for a in r.get("annotations", [])}
                taken = set()
                for b, s, c, v in zip(dets["boxes"][i], dets["scores"][i],
                                      dets["classes"][i], dets["valid"][i]):
                    c = int(c)
                    if not v or c not in present:
                        continue
                    if args.per_class_top1 and c in taken:
                        continue
                    if s < args.score_thresh and c in taken:
                        continue
                    taken.add(c)
                    x1, y1, x2, y2 = [float(x) for x in b]
                    annotations.append({
                        "id": ann_id, "image_id": img_id,
                        "category_id": c + 1,
                        "bbox": [x1, y1, x2 - x1, y2 - y1],
                        "area": (x2 - x1) * (y2 - y1),
                        "iscrowd": 0, "score": float(s),
                    })
                    ann_id += 1

    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": i + 1, "name": n}
                       for i, n in enumerate(class_names or [])],
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(coco, f)
    logger.info(f"Wrote {len(annotations)} pseudo boxes over "
                f"{len(images)} images to {args.out}")
    return coco


if __name__ == "__main__":
    main()
