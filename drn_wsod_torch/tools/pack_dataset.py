"""Pack a registered dataset, its proposals and its decoded pixels into a
record shard for the training data path (counterpart of
``tools/pack_dataset.py``; the format is ``data/record_dataset.py``'s):

    python -m drn_wsod_torch.tools.pack_dataset --dataset voc_2007_trainval \\
        --proposals datasets/proposals/mcg_voc_2007_trainval_d2.pkl \\
        --out datasets/packed/voc_2007_trainval.rec

The datasets ``train_net`` registers (VOC, COCO, the web and VOC-SBD
sets) live under ``$DETECTRON2_DATASETS`` (default ``datasets``). JPEG
images decode with the port's own decoder (``native.py``), without Pillow;
other formats need Pillow. Training from the shard decodes nothing.
"""

from __future__ import annotations

import argparse
import os

from ..data.datasets.builtin import register_all
from ..data.loader import get_detection_dataset_dicts
from ..data.record_dataset import pack_dataset


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", required=True)
    p.add_argument("--proposals", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--no-images", action="store_true",
                   help="leave the pixels out (the mapper then decodes)")
    args = p.parse_args(argv)

    register_all(os.environ.get("DETECTRON2_DATASETS", "datasets"))
    records = get_detection_dataset_dicts(
        [args.dataset], [args.proposals] if args.proposals else ())
    n = pack_dataset(records, args.out, decode_images=not args.no_images)
    size = os.path.getsize(args.out) / 1e6
    print(f"Packed {n} records ({size:.1f} MB) to {args.out}")
    return n


if __name__ == "__main__":
    main()
