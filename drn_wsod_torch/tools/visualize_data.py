"""Draw training samples after augmentation (counterpart of
``tools/visualize_data.py``): the first ``--n`` records of
``DATASETS.TRAIN`` through the training mapper, each with its GT boxes and
its first ``--show-proposals`` proposals (unlabelled), as
``OUTPUT/sample_{i:04d}.png``.

    python -m drn_wsod_torch.tools.visualize_data --config-file CONFIG \\
        --output DIR [--n 10] [--show-proposals 20] [KEY VALUE ...]

VOC lives under ``$DETECTRON2_DATASETS`` (default ``datasets``). Host only:
no model, no card; drawn by ``utils/visualizer.py``, without Pillow.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch visualize_data")
    p.add_argument("--config-file", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--n", type=int, default=10)
    p.add_argument("--show-proposals", type=int, default=20)
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p


def main(argv=None) -> int:
    """Write the samples; returns how many."""
    from ..config import get_cfg
    from ..data import DatasetMapper, MetadataCatalog
    from ..data.datasets.voc import register_all_pascal_voc
    from ..data.loader import get_detection_dataset_dicts
    from ..utils.visualizer import Visualizer

    args = argument_parser().parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    register_all_pascal_voc(os.environ.get("DETECTRON2_DATASETS", "datasets"))

    names = MetadataCatalog.get(cfg.DATASETS.TRAIN[0]).thing_classes
    records = get_detection_dataset_dicts(
        cfg.DATASETS.TRAIN,
        cfg.DATASETS.PROPOSAL_FILES_TRAIN if cfg.MODEL.LOAD_PROPOSALS else ())
    mapper = DatasetMapper(cfg, is_train=True)
    rng = np.random.RandomState(0)

    os.makedirs(args.output, exist_ok=True)
    for i, r in enumerate(records[:args.n]):
        s = mapper(r, rng, dataset_index=i)
        v = Visualizer(s["image"].astype(np.uint8), names)
        for g in range(int(s["gt_valid"].sum())):
            v.draw_box(s["gt_boxes"][g], int(s["gt_classes"][g]))
        for pi in range(min(args.show_proposals,
                            int(s["proposal_mask"].sum()))):
            v.draw_box(s["proposals"][pi], class_id=None)
        v.save(os.path.join(args.output, f"sample_{i:04d}.png"))
    n = min(args.n, len(records))
    print(f"Wrote {n} samples to {args.output}")
    return n


if __name__ == "__main__":
    main()
