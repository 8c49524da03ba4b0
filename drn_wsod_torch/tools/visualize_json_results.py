"""Draw the detections of a COCO-format results list or instances json
onto their images (counterpart of ``tools/visualize_json_results.py``).

    python -m drn_wsod_torch.tools.visualize_json_results --input JSON \\
        --image-root DIR --output DIR [--conf 0.3] [--limit 50]

Each image is written under its own basename, so a VOC image stays a
``.jpg`` (``native.py:jpeg_encode``, the bytes of Pillow's default
``save``); an image the json names but the root lacks is skipped. Host
only; drawn by ``utils/visualizer.py``, without Pillow.
"""

from __future__ import annotations

import argparse
import json
import os


def argument_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="drn_wsod_torch visualize_json_results")
    p.add_argument("--input", required=True)
    p.add_argument("--image-root", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--conf", type=float, default=0.3)
    p.add_argument("--limit", type=int, default=50)
    return p


def main(argv=None) -> list:
    """Write the drawings; returns their paths."""
    from ..data.mapper import read_image
    from ..utils.visualizer import Visualizer

    args = argument_parser().parse_args(argv)
    with open(args.input) as f:
        data = json.load(f)

    if isinstance(data, dict):   # instances json
        id_to_file = {im["id"]: im["file_name"] for im in data["images"]}
        cats = {c["id"]: c["name"] for c in data.get("categories", [])}
        anns = data["annotations"]
    else:                        # bare results list
        id_to_file, cats, anns = {}, {}, data

    by_image = {}
    for a in anns:
        by_image.setdefault(a["image_id"], []).append(a)

    os.makedirs(args.output, exist_ok=True)
    names = [cats.get(i) or str(i) for i in range(1, max(cats, default=1) + 1)]
    written = []
    for n, (img_id, dets) in enumerate(sorted(by_image.items())):
        if n >= args.limit:
            break
        fname = id_to_file.get(img_id, f"{img_id}.jpg")
        path = os.path.join(args.image_root, fname)
        if not os.path.exists(path):
            continue
        v = Visualizer(read_image(path, "BGR"), names)
        for a in dets:
            score = a.get("score", 1.0)
            if score < args.conf:
                continue
            x, y, w, h = a["bbox"]
            v.draw_box([x, y, x + w, y + h], a["category_id"] - 1, score)
        dst = os.path.join(args.output, os.path.basename(fname))
        v.save(dst)
        written.append(dst)
    print(f"Wrote visualizations to {args.output}")
    return written


if __name__ == "__main__":
    main()
