"""Evaluation CLI of the port (counterpart of ``tools/train_net.py``'s
``--eval-only`` path): build the configured model, load Detectron2 weights
from ``MODEL.WEIGHTS``, and evaluate ``DATASETS.TEST`` (and, with
``TEST.EVAL_TRAIN``, the train datasets, for CorLoc) with TTA-AVG and the
VOC evaluator.

    python -m drn_wsod_torch.tools.train_net --config-file CONFIG \\
        --eval-only [KEY VALUE ...]

VOC lives under ``$DETECTRON2_DATASETS`` (default ``datasets``) as
``VOC2007/{Annotations,ImageSets/Main,JPEGImages}``. Runs on the CUDA
device. Training, ``--resume`` and the Checkpointer come with ROADMAP.md
queue 1, item 11; evaluation without TTA needs the test loader (item 10);
evaluator types other than Pascal VOC come with item 15.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict

from ..checkpoint import load_reference_weights
from ..config import get_cfg
from ..data import MetadataCatalog, get_detection_dataset_dicts
from ..data.datasets.voc import register_all_pascal_voc
from ..device import resolve_device
from ..evaluation import PascalVOCDetectionEvaluator, gather_and_evaluate
from ..evaluation.testing import print_csv_format, verify_results
from ..models import build_model
from ..tta import GeneralizedRCNNWithTTAAVG

logger = logging.getLogger("drn_wsod_torch")


def argument_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="drn_wsod_torch evaluation (the --eval-only path)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="dotted-key config overrides")
    return parser


def setup(args):
    """The frozen config of ``args``; logging to standard output."""
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="[%(asctime)s %(name)s]: %(message)s")
    return cfg


def build_evaluator(cfg, dataset_name: str, records):
    """The dataset's evaluator: Pascal VOC's AP and CorLoc."""
    meta = MetadataCatalog.get(dataset_name)
    etype = meta.get("evaluator_type", "pascal_voc")
    if etype != "pascal_voc":
        raise NotImplementedError(
            f"evaluator type {etype!r} is not ported yet: ROADMAP.md queue "
            "1, item 15 (remaining evaluators)")
    gt_by_image = {str(r["image_id"]): r.get("annotations", [])
                   for r in records}
    return PascalVOCDetectionEvaluator(
        meta.thing_classes, gt_by_image, year=meta.get("year", 2007))


def do_test(cfg, model, eval_train: bool = False,
            device=None) -> Dict[str, Dict]:
    """Evaluate ``model`` on each test dataset (with its own proposal file)
    and, with ``eval_train`` and ``TEST.EVAL_TRAIN``, each train dataset;
    TTA-AVG over ``TEST.AUG`` on ``device`` (CUDA unless the caller names
    another one). Returns {dataset: results}."""
    dev = resolve_device(device)
    if not cfg.TEST.AUG.ENABLED:
        raise NotImplementedError(
            "evaluation without TTA needs the test loader, not ported yet: "
            "ROADMAP.md queue 1, item 10 (data path)")

    def _pairs(names, files):
        files = list(files)
        return [(n, files[i] if i < len(files) else None)
                for i, n in enumerate(names)]

    pairs = _pairs(cfg.DATASETS.TEST, cfg.DATASETS.PROPOSAL_FILES_TEST)
    if eval_train and cfg.TEST.EVAL_TRAIN:
        pairs += _pairs(cfg.DATASETS.TRAIN, cfg.DATASETS.PROPOSAL_FILES_TRAIN)

    tta = GeneralizedRCNNWithTTAAVG(cfg, model, device=dev)
    results = {}
    for name, prop_file in pairs:
        pf = [prop_file] if cfg.MODEL.LOAD_PROPOSALS and prop_file else ()
        records = get_detection_dataset_dicts([name], pf, filter_empty=False)
        evaluator = build_evaluator(cfg, name, records)
        evaluator.reset()
        for r in records:
            dets = tta(r)
            evaluator.process_single(
                str(r["image_id"]), dets["boxes"], dets["scores"],
                dets["classes"], dets["valid"])
        results[name] = gather_and_evaluate(evaluator)
        logger.info(f"Results on {name}: {results[name]}")
        print_csv_format(results[name])

    if cfg.TEST.EXPECTED_RESULTS and pairs:
        if not verify_results(cfg, results[pairs[0][0]]):
            raise RuntimeError("Results verification failed!")
    return results


def main(args, device=None):
    """``--eval-only``: register VOC under ``$DETECTRON2_DATASETS``, build
    the model on ``device`` (CUDA unless the caller names another one),
    load ``MODEL.WEIGHTS`` when set, and evaluate."""
    if not args.eval_only or args.resume:
        raise SystemExit(
            "only --eval-only (without --resume) is ported: training and "
            "the Checkpointer come with ROADMAP.md queue 1, item 11 "
            "(engine, checkpoint, CLI)")
    dev = resolve_device(device)
    cfg = setup(args)
    register_all_pascal_voc(os.environ.get("DETECTRON2_DATASETS", "datasets"))
    model = build_model(cfg, device=dev)
    if cfg.MODEL.WEIGHTS:
        load_reference_weights(cfg.MODEL.WEIGHTS, model)
    return do_test(cfg, model, eval_train=True, device=dev)


if __name__ == "__main__":
    main(argument_parser().parse_args())
