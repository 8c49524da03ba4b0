"""Convert Selective-Search and MCG proposal files into the proposal
pickle the loaders read (counterpart of ``tools/proposal_convert.py``:
{"ids", "boxes", "objectness_logits", "bbox_mode"}).

    python -m drn_wsod_torch.tools.proposal_convert ss  voc_2007_train SS.mat out.pkl
    python -m drn_wsod_torch.tools.proposal_convert mcg voc_2007_train mcg_dir/ out.pkl

The ``.mat`` files are read by ``scipy.io.loadmat``. VOC is registered
under ``$DETECTRON2_DATASETS`` (default ``datasets``). Host only.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def convert_ss_box(dataset_name: str, mat_path: str, out_path: str):
    """Selective-Search ``.mat``: 1-based (y1, x1, y2, x2) -> 0-based XYXY.
    The scores are all ones, as in the reference: they feed the WSDDN
    (objectness + 1) feature scale, so the constant matters."""
    from scipy.io import loadmat

    from ..data import DatasetCatalog

    data = loadmat(mat_path)
    raw_boxes = data["boxes"].ravel()
    raw_images = data.get("images")
    records = DatasetCatalog.get(dataset_name)

    ids, boxes, scores = [], [], []
    index = {}
    if raw_images is not None:
        for i, im in enumerate(raw_images.ravel()):
            index[str(np.squeeze(im))] = i
    for j, r in enumerate(records):
        i = index.get(str(r["image_id"]), j)
        b = raw_boxes[i].astype(np.float32)
        b = b[:, (1, 0, 3, 2)] - 1.0          # y1x1y2x2 (1-based) -> x1y1x2y2
        ids.append(r["image_id"])
        boxes.append(b)
        scores.append(np.ones(len(b), dtype=np.float32))
    _dump(ids, boxes, scores, out_path)


def _mcg_key(record: dict, dataset_name: str) -> str:
    """Per-image MCG file stem: the image id for VOC-style datasets, the
    file name's stem for COCO and Flickr."""
    if "flickr" in dataset_name or "coco" in dataset_name:
        return os.path.splitext(os.path.basename(record["file_name"]))[0]
    return str(record["image_id"])


def convert_mcg_box(dataset_name: str, mcg_dir: str, out_path: str):
    """MCG per-image ``.mat`` files with "boxes" (1-based y1, x1, y2, x2)
    and "scores", or "bboxes" / "bboxes_scores" for the Flickr web sets."""
    from scipy.io import loadmat

    from ..data import DatasetCatalog

    records = DatasetCatalog.get(dataset_name)
    ids, boxes, scores = [], [], []
    for r in records:
        m = loadmat(os.path.join(mcg_dir, f"{_mcg_key(r, dataset_name)}.mat"))
        if "flickr" in dataset_name:
            raw_b, raw_s = m["bboxes"], m["bboxes_scores"]
        else:
            raw_b, raw_s = m["boxes"], m["scores"]
        b = raw_b.astype(np.float32)
        b = b[:, (1, 0, 3, 2)] - 1.0
        s = np.squeeze(raw_s).astype(np.float32)
        ids.append(r["image_id"])
        boxes.append(b)
        scores.append(s)
    _dump(ids, boxes, scores, out_path)


def _dump(ids, boxes, scores, out_path):
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump({"ids": ids, "boxes": boxes,
                     "objectness_logits": scores, "bbox_mode": 0}, f)
    print(f"Wrote {len(ids)} images of proposals to {out_path}")


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="drn_wsod_torch proposal_convert")
    p.add_argument("method", choices=["ss", "mcg"])
    p.add_argument("dataset")
    p.add_argument("src")
    p.add_argument("out")
    return p


def main(argv=None) -> None:
    from ..data.datasets.voc import register_all_pascal_voc

    args = argument_parser().parse_args(argv)
    register_all_pascal_voc(os.environ.get("DETECTRON2_DATASETS", "datasets"))
    if args.method == "ss":
        convert_ss_box(args.dataset, args.src, args.out)
    else:
        convert_mcg_box(args.dataset, args.src, args.out)


if __name__ == "__main__":
    main()
