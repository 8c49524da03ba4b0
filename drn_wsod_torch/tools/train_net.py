"""Training and evaluation CLI of the port (counterpart of
``tools/train_net.py``): train the configured model on ``DATASETS.TRAIN``
with periodic checkpoints, metrics and evaluation, then evaluate
``DATASETS.TEST`` (and, with ``TEST.EVAL_TRAIN``, the train datasets, for
CorLoc): with TTA-AVG where ``TEST.AUG.ENABLED``, through the test loader
otherwise, into the VOC or the COCO evaluator (box AP, and mask and
keypoint AP where ``MODEL.MASK_ON`` and ``MODEL.KEYPOINT_ON`` are set); a
"sem_seg" dataset into mIoU, a COCO panoptic one into instance AP and
PQ (``do_dense_test``).

    python -m drn_wsod_torch.tools.train_net --config-file CONFIG \\
        [--resume] [--eval-only] [KEY VALUE ...]

``--resume`` continues from the latest checkpoint under
``OUTPUT_DIR/checkpoints`` (else ``MODEL.WEIGHTS``, Detectron2 weights, is
loaded); ``--eval-only`` evaluates without training. VOC lives under
``$DETECTRON2_DATASETS`` (default ``datasets``) as
``VOC2007/{Annotations,ImageSets/Main,JPEGImages}``, COCO as
``coco/{train2014,val2014,annotations}`` (and 2017), LVIS v1 as
``lvis/lvis_v1_{train,val}.json`` over the images in ``coco/``, the web
and VOC-SBD sets as COCO-format json where present; a dataset packed with
``drn_wsod_torch.tools.pack_dataset`` registers in ``DatasetCatalog``
under a name of its own. Runs on the CUDA device. The CSC heads train
with the CSC step while ``iter <= WSL.CSC_MAX_ITER`` and the plain step
after it (WSJDS among them). ``NORM`` BN/SyncBN or
``TEST.PRECISE_BN.ENABLED`` adds the PreciseBN hook. LVIS under
``lvis/``, Cityscapes where the caller registers it
(``data.datasets.register_all_cityscapes``), each into its own evaluator.
``VIS_PERIOD`` (or ``WSL.VIS_TEST``) adds ``PGTVisualization`` for the
OICR, PCL and WSDDN heads: PNGs of the mined pseudo-GT boxes under
``OUTPUT_DIR/pgt_vis``.

Several processes, one a card:

    torchrun --nproc_per_node=N -m drn_wsod_torch.tools.train_net \\
        --config-file CONFIG [KEY VALUE ...]

``main`` initialises the process group from ``torchrun``'s environment
(NCCL; a caller may initialise its own, gloo included, first) and puts each
rank on ``cuda:LOCAL_RANK``. ``PARALLEL.MESH_AXES`` / ``MESH_SHAPE`` lay
the ranks out (``parallel/mesh.py``): each data rank loads and steps on its
slice of the ``IMS_PER_BATCH`` global batch, and under a ``model`` axis the
DAN is split. Rank 0 alone writes metrics, logs to standard output and
writes ``config.yaml``; every rank takes part in the checkpoints (rank 0
writes them) and in the evaluation (each rank detects on its shard of the
images, rank 0 evaluates them all; the others' results are {}).
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict

import torch

from ..checkpoint import Checkpointer
from ..config import get_cfg
from ..data import (DatasetMapper, MetadataCatalog,
                    build_detection_test_loader, build_detection_train_loader,
                    get_detection_dataset_dicts)
from ..data.datasets.builtin import register_all
from ..device import resolve_device
from ..engine import (CommonMetricPrinter, EvalHook, IterationTimer,
                      JSONWriter, PeriodicCheckpointer, PeriodicWriter,
                      PGTVisualization, PreciseBNHook, TensorboardWriter,
                      Trainer,
                      create_train_state)
from ..engine import trainer as trainer_lib
from ..engine.defaults import default_argument_parser, default_setup
from ..evaluation import (COCODetectionEvaluator, CityscapesInstanceEvaluator,
                          CityscapesSemSegEvaluator, LVISDetectionEvaluator,
                          PanopticQualityEvaluator,
                          PascalVOCDetectionEvaluator,
                          RotatedCOCODetectionEvaluator, SemSegEvaluator,
                          gather_and_evaluate, inference_on_dataset,
                          make_detect_fn, make_sem_seg_fn,
                          panoptic_inference_on_dataset,
                          sem_seg_inference_on_dataset)
from ..evaluation.testing import print_csv_format, verify_results
from ..models import build_model
from ..models.build import CSC_HEAD_NAMES
from ..parallel import multihost
from ..parallel.mesh import create_mesh, gathered
from ..parallel.train_parallel import (make_sharded_csc_train_step,
                                       make_sharded_train_step)
from ..solver import build_optimizer
from ..solver.build import build_lr_schedule
from ..tta import GeneralizedRCNNWithTTAAVG

logger = logging.getLogger("drn_wsod_torch")

LOG_PERIOD = 20

argument_parser = default_argument_parser


def setup(args):
    """The frozen config of ``args``; the run set up by
    ``default_setup`` (OUTPUT_DIR, logging, the seed, config.yaml)."""
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    cfg.freeze()
    default_setup(cfg, args)
    return cfg


def build_evaluator(cfg, dataset_name: str, records):
    """The dataset's evaluator, by its metadata's ``evaluator_type``:
    Pascal VOC's AP and CorLoc; Cityscapes' instance-mask AP
    ("cityscapes_instance" under ``MASK_ON``); COCO's AP (the "coco" and
    "coco_panoptic_seg" types, and "cityscapes_instance" without masks):
    box AP, with "segm" under ``MASK_ON`` and "keypoints" under
    ``KEYPOINT_ON``; rotated box AP ("rotated_coco"); Cityscapes' 19-class
    pixel IoU over raw labelIds ("cityscapes_sem_seg"); mIoU ("sem_seg")
    over the metadata's ``stuff_classes`` (else ``thing_classes``); or
    LVIS's federated AP ("lvis"), each image's negative and
    not-exhaustive classes taken from its record."""
    meta = MetadataCatalog.get(dataset_name)
    etype = meta.get("evaluator_type", "pascal_voc")
    gt_by_image = {str(r["image_id"]): r.get("annotations", [])
                   for r in records}
    if etype == "pascal_voc":
        return PascalVOCDetectionEvaluator(
            meta.thing_classes, gt_by_image, year=meta.get("year", 2007))
    if etype == "cityscapes_instance" and cfg.MODEL.MASK_ON:
        return CityscapesInstanceEvaluator(meta.thing_classes, gt_by_image)
    if etype in ("coco", "coco_panoptic_seg", "cityscapes_instance"):
        tasks = ["bbox"]
        if cfg.MODEL.MASK_ON:
            tasks.append("segm")
        if cfg.MODEL.KEYPOINT_ON:
            tasks.append("keypoints")
        return COCODetectionEvaluator(meta.thing_classes, gt_by_image,
                                      tasks=tuple(tasks))
    if etype == "rotated_coco":
        return RotatedCOCODetectionEvaluator(meta.thing_classes, gt_by_image)
    if etype == "cityscapes_sem_seg":
        return CityscapesSemSegEvaluator()
    if etype == "sem_seg":
        return SemSegEvaluator(
            meta.get("stuff_classes") or meta.thing_classes,
            ignore_label=meta.get("ignore_label", 255))
    if etype == "lvis":
        info = {str(r["image_id"]): {
            "neg_category_ids": r.get("neg_category_ids", []),
            "not_exhaustive_category_ids":
                r.get("not_exhaustive_category_ids", [])}
            for r in records}
        return LVISDetectionEvaluator(
            meta.thing_classes, gt_by_image, info,
            frequencies=meta.get("thing_frequencies"))
    raise NotImplementedError(f"evaluator type {etype!r}")


def do_test(cfg, model, eval_train: bool = False,
            device=None) -> Dict[str, Dict]:
    """Evaluate ``model`` on each test dataset (with its own proposal file)
    and, with ``eval_train`` and ``TEST.EVAL_TRAIN``, each train dataset,
    on ``device`` (CUDA unless the caller names another one): TTA-AVG over
    ``TEST.AUG`` where enabled, else the test loader (the test resize, one
    image a batch) into ``make_detect_fn``, with its mask and keypoint arms
    where ``MASK_ON`` / ``KEYPOINT_ON`` are set. Returns {dataset:
    results}. Over several processes each rank detects on its shard of
    the images with the DAN made whole, and rank 0 evaluates them all
    (the others return {} for each dataset)."""
    with gathered(model):
        return _do_test(cfg, model, eval_train, resolve_device(device))


def _do_test(cfg, model, eval_train: bool, dev) -> Dict[str, Dict]:

    def _pairs(names, files):
        files = list(files)
        return [(n, files[i] if i < len(files) else None)
                for i, n in enumerate(names)]

    pairs = _pairs(cfg.DATASETS.TEST, cfg.DATASETS.PROPOSAL_FILES_TEST)
    if eval_train and cfg.TEST.EVAL_TRAIN:
        pairs += _pairs(cfg.DATASETS.TRAIN, cfg.DATASETS.PROPOSAL_FILES_TRAIN)

    results = {}
    mapper = DatasetMapper(cfg, is_train=False)
    tta = detect = None
    for name, prop_file in pairs:
        etype = MetadataCatalog.get(name).get("evaluator_type", "pascal_voc")
        if etype in ("sem_seg", "cityscapes_sem_seg", "coco_panoptic_seg") \
                or (etype == "cityscapes_instance" and cfg.MODEL.MASK_ON):
            pf = [prop_file] if cfg.MODEL.LOAD_PROPOSALS and prop_file else ()
            records = get_detection_dataset_dicts([name], pf,
                                                  filter_empty=False)
            results[name] = do_dense_test(cfg, model, name, mapper, records,
                                          etype, prop_file, device=dev)
            logger.info(f"Results on {name}: {results[name]}")
            continue
        if cfg.TEST.AUG.ENABLED:
            tta = tta or GeneralizedRCNNWithTTAAVG(cfg, model, device=dev)
            pf = [prop_file] if cfg.MODEL.LOAD_PROPOSALS and prop_file else ()
            records = get_detection_dataset_dicts([name], pf,
                                                  filter_empty=False)
            evaluator = build_evaluator(cfg, name, records)
            evaluator.reset()
            rank, world = multihost.get_rank(), multihost.get_world_size()
            for r in records[rank::world]:
                dets = tta(r)
                evaluator.process_single(
                    str(r["image_id"]), dets["boxes"], dets["scores"],
                    dets["classes"], dets["valid"])
            results[name] = gather_and_evaluate(evaluator)
        else:
            detect = detect or _detect_fn(cfg, model, dev)
            loader = build_detection_test_loader(cfg, name, mapper,
                                                 proposal_file=prop_file)
            evaluator = build_evaluator(cfg, name, loader.all_records)
            results[name] = inference_on_dataset(detect, loader, evaluator,
                                                 loader._records)
        logger.info(f"Results on {name}: {results[name]}")
        print_csv_format(results[name])

    if cfg.TEST.EXPECTED_RESULTS and pairs and multihost.is_main_process():
        if not verify_results(cfg, results[pairs[0][0]]):
            raise RuntimeError("Results verification failed!")
    return results


def _detect_fn(cfg, model, device):
    return make_detect_fn(model, cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
                          cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
                          cfg.TEST.DETECTIONS_PER_IMAGE, device=device,
                          mask_on=cfg.MODEL.MASK_ON,
                          keypoint_on=cfg.MODEL.KEYPOINT_ON)


def do_dense_test(cfg, model, name: str, mapper, records, etype: str,
                  proposal_file=None, device=None) -> Dict:
    """A dense dataset's evaluation through the test loader, without TTA:
    mIoU of ``make_sem_seg_fn``'s maps for "sem_seg" and
    "cityscapes_sem_seg"; otherwise the
    instance AP of ``make_detect_fn`` (masks under ``MASK_ON``) and, where
    the records carry panoptic PNGs, PQ over the fused output in the
    space of n_thing + n_stuff - 1 categories (n_stuff counts the "thing"
    class; ``SEM_SEG_HEAD.NUM_CLASSES`` where the metadata names no
    ``stuff_classes``)."""
    dev = resolve_device(device)
    meta = MetadataCatalog.get(name)
    loader = build_detection_test_loader(cfg, name, mapper,
                                         proposal_file=proposal_file)
    sem = make_sem_seg_fn(model, device=dev)
    if etype in ("sem_seg", "cityscapes_sem_seg"):
        evaluator = build_evaluator(cfg, name, records)
        return sem_seg_inference_on_dataset(sem, loader, evaluator,
                                            loader._records)
    if not hasattr(model, "inference_scores"):
        raise ValueError(
            f"{type(model).__name__} detects no instances, which the "
            f"evaluation of {name!r} (evaluator type {etype!r}: instance AP "
            "and PQ) needs; evaluate it on a 'sem_seg' dataset (the JAX "
            "CLI stops here too, on the missing inference_scores)")
    detect = _detect_fn(cfg, model, dev)
    results = dict(inference_on_dataset(
        detect, loader, build_evaluator(cfg, name, records),
        loader._records))
    if any("pan_seg_file_name" in r for r in records):
        n_thing = len(meta.thing_classes)
        n_stuff = len(meta.get("stuff_classes") or []) or \
            cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
        combine = cfg.MODEL.PANOPTIC_FPN.COMBINE
        loader = build_detection_test_loader(cfg, name, mapper,
                                             proposal_file=proposal_file)
        results.update(panoptic_inference_on_dataset(
            detect, sem, loader, PanopticQualityEvaluator(
                n_thing + n_stuff - 1), loader._records,
            num_thing_classes=n_thing,
            overlap_threshold=combine.OVERLAP_THRESH,
            stuff_area_limit=combine.STUFF_AREA_LIMIT,
            conf_threshold=combine.INSTANCES_CONFIDENCE_THRESH))
    return results


def steps_per_dispatch(cfg) -> int:
    """``SOLVER.STEPS_PER_DISPATCH`` reduced by gcd against every active
    hook period (the log period, checkpoints, evaluation, visualisation),
    so that each hook sees the state it would see one step at a time; 1
    for the CSC heads, whose step is chosen per iteration."""
    if cfg.MODEL.ROI_HEADS.NAME in CSC_HEAD_NAMES:
        return 1
    k = max(int(cfg.SOLVER.STEPS_PER_DISPATCH), 1)
    for period in (LOG_PERIOD, cfg.SOLVER.CHECKPOINT_PERIOD,
                   cfg.TEST.EVAL_PERIOD, vis_period(cfg)):
        if period and period > 0:
            k = math.gcd(k, int(period))
    return k


PGT_HEADS = ("OICRROIHeads", "PCLROIHeads", "WSDDNROIHeads")


def vis_period(cfg) -> int:
    """The pseudo-GT visualisation period: ``VIS_PERIOD``, else
    ``SOLVER.CHECKPOINT_PERIOD`` under ``WSL.VIS_TEST``, else 0 (off).
    It bounds the steps a dispatch for every head, as in the JAX trainer;
    the hook itself is added only for ``PGT_HEADS``."""
    return cfg.VIS_PERIOD or (
        cfg.SOLVER.CHECKPOINT_PERIOD if cfg.WSL.VIS_TEST else 0)


def _writers(cfg):
    """The printer, metrics.json and, where the tensorboard package is
    installed, TensorBoard (left out with one warning otherwise)."""
    writers = [CommonMetricPrinter(cfg.SOLVER.MAX_ITER),
               JSONWriter(os.path.join(cfg.OUTPUT_DIR, "metrics.json"))]
    try:
        writers.append(TensorboardWriter(os.path.join(cfg.OUTPUT_DIR, "tb")))
    except ImportError as e:
        logger.warning(f"TensorboardWriter left out: the tensorboard package "
                       f"is missing ({e}); metrics.json and the printer "
                       "stay")
    return writers


def do_train(cfg, model, resume: bool = False, device=None) -> Trainer:
    """Train ``model`` in place on ``device`` (CUDA unless the caller names
    another one) from ``SOLVER`` and the train loader; resume from the
    latest checkpoint where ``resume`` and one exists, else start from
    ``MODEL.WEIGHTS`` where set. K = ``steps_per_dispatch(cfg)`` steps are
    pulled and run per call where K > 1. A CSC head takes the CSC step
    while the iteration is at most ``WSL.CSC_MAX_ITER`` and the plain step
    after it. ``NORM`` BN/SyncBN or ``TEST.PRECISE_BN.ENABLED`` adds the
    PreciseBN hook (every ``TEST.EVAL_PERIOD``, else every
    ``SOLVER.CHECKPOINT_PERIOD``, over ``NUM_ITER`` batches of a fresh
    iterator of the train loader). Returns the trainer (its ``state``
    holds the model, the optimizer state and the step).

    The steps run over the mesh of ``PARALLEL.MESH_AXES`` /
    ``MESH_SHAPE`` (``parallel/train_parallel.py``; one rank without a
    process group): the loader yields the data rank's slice of each global
    batch, the state is resumed or loaded whole, then split where the mesh
    has a ``model`` axis over 1. The writers run on rank 0 alone."""
    dev = resolve_device(device)
    mesh = create_mesh(tuple(cfg.PARALLEL.MESH_AXES),
                       tuple(cfg.PARALLEL.MESH_SHAPE))
    mapper = DatasetMapper(cfg, is_train=True)
    loader = build_detection_train_loader(cfg, mapper,
                                          process_index=mesh.data_rank,
                                          process_count=mesh.data_size)

    tx = build_optimizer(cfg, model)
    state = create_train_state(model, tx)
    checkpointer = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "checkpoints"))
    state, start_iter = checkpointer.resume_or_load(
        state, cfg.MODEL.WEIGHTS, resume=resume)

    step = make_sharded_train_step(model, tx, mesh, state=state)
    if cfg.MODEL.ROI_HEADS.NAME in CSC_HEAD_NAMES:
        plain_step = step
        csc_step = make_sharded_csc_train_step(model, tx, mesh, state=state)

        def step(state, batch, seed):
            fn = (csc_step if trainer.iter <= cfg.WSL.CSC_MAX_ITER
                  else plain_step)
            return fn(state, batch, seed)
    k = steps_per_dispatch(cfg)
    trainer = Trainer(
        step, state, iter(loader), seed=max(cfg.SEED, 0),
        lr_schedule=build_lr_schedule(cfg), log_period=LOG_PERIOD,
        multi_step_fn=trainer_lib.make_multi_train_step(step) if k > 1
        else None,
        steps_per_dispatch=k, device=dev)
    if k > 1:
        logger.info(f"Chunked training: {k} steps a call")
    hooks = [IterationTimer()]
    if multihost.is_main_process():
        hooks.append(PeriodicWriter(_writers(cfg)))
    hooks.append(PeriodicCheckpointer(checkpointer,
                                      cfg.SOLVER.CHECKPOINT_PERIOD))
    if cfg.MODEL.RESNETS.NORM in ("BN", "SyncBN") or \
            cfg.TEST.PRECISE_BN.ENABLED:
        hooks.append(PreciseBNHook(
            cfg.TEST.EVAL_PERIOD or cfg.SOLVER.CHECKPOINT_PERIOD,
            lambda: iter(loader), num_iters=cfg.TEST.PRECISE_BN.NUM_ITER))
    if vis_period(cfg) > 0 and cfg.MODEL.ROI_HEADS.NAME in PGT_HEADS:
        meta = (MetadataCatalog.get(cfg.DATASETS.TRAIN[0])
                if cfg.DATASETS.TRAIN else None)
        hooks.append(PGTVisualization(
            vis_period(cfg), model, cfg.OUTPUT_DIR,
            class_names=meta.get("thing_classes") if meta else None))
    if cfg.TEST.EVAL_PERIOD > 0:
        hooks.append(EvalHook(
            cfg.TEST.EVAL_PERIOD,
            lambda: do_test(cfg, trainer.state.model, device=dev)))
    trainer.register_hooks(hooks)
    trainer.train(start_iter, cfg.SOLVER.MAX_ITER)
    return trainer


def main(args, device=None):
    """Register VOC, COCO, LVIS, the web and the VOC-SBD sets under
    ``$DETECTRON2_DATASETS``, build the model on
    ``device`` (CUDA unless the caller names another one), then train and
    evaluate, or, with ``--eval-only``, load the weights (the latest
    checkpoint with ``--resume``, else ``MODEL.WEIGHTS``) and evaluate.

    Under ``torchrun`` (``WORLD_SIZE`` > 1) the process group is
    initialised from the environment where the caller has not initialised
    one, and the rank runs on ``cuda:LOCAL_RANK`` unless the caller names
    a device."""
    multihost.init_process_group()
    if device is None and multihost.get_world_size() > 1:
        device = f"cuda:{multihost.get_local_rank()}"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    cfg = setup(args)
    register_all(os.environ.get("DETECTRON2_DATASETS", "datasets"))
    model = build_model(cfg, device=dev)
    if args.eval_only:
        state = create_train_state(model, build_optimizer(cfg, model))
        Checkpointer(os.path.join(cfg.OUTPUT_DIR, "checkpoints")) \
            .resume_or_load(state, cfg.MODEL.WEIGHTS, resume=args.resume)
        return do_test(cfg, model, eval_train=True, device=dev)
    trainer = do_train(cfg, model, resume=args.resume, device=dev)
    return do_test(cfg, trainer.state.model, eval_train=True, device=dev)


if __name__ == "__main__":
    main(default_argument_parser().parse_args())
