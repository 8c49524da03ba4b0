"""The port's training entry point on the four YAMLs of the supervised and
pyramid paths, on the CPU: ``tools/train_net.py:main`` trains 3 steps,
checkpoints at 2 and 3, and evaluates the test split:

  * ``retrain_fast_rcnn_WSR_50_DC5_1x`` and ``cascade_rcnn_WSR_50_DC5_1x``
    on a VOC-layout directory (their instance GT from the XML boxes), into
    the VOC evaluator (AP and CorLoc), without TTA as the YAMLs say;
  * ``oicr_WSR_50_DC5_deform_1x`` on the same VOC data with the YAML's TTA
    (two scales and flip here);
  * ``COCO-Detection/fpn_oicr_WSR_50_1x`` on a COCO-format split into the
    COCO box evaluator, with TTA;
  * ``Misc/mask_rcnn_R_50_FPN_1x`` (Fast R-CNN with the mask head over the
    FPN, ROIAlignV2) on the same COCO split (polygon and crowd RLE
    segmentations) into the COCO box and mask evaluator, without TTA, the
    mask head's pool at 4 x 4.

Each is cut to a toy size (R18, or a narrow R50 where the blocks must be
bottlenecks, FPN 16 channels, DAN [64, 64], P = 90, 64-pixel images,
float32) from seeded random weights. Checked: every step's losses finite
under the head's names, the checkpoints, the metrics finite in [0, 100],
and ``--eval-only --resume`` reproducing the evaluation. The steps
themselves are held against the JAX package in
``tests/test_torch_supervised.py`` and ``tests/test_torch_pyramid_steps.py``.
"""

import math

import pytest
import torch

from drn_wsod_torch import data as pdata
from drn_wsod_torch.checkpoint import Checkpointer
from drn_wsod_torch.data.datasets import coco as pcoco
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_torch.engine import trainer as ptrainer
from drn_wsod_torch.tools import train_net
from test_torch_coco_train_net import write_coco_split
from test_torch_common import CONFIGS, NARROW_R50, TOY, write_voc
from test_torch_train_net import TEST_SIZES, TRAIN_SIZES

torch.set_num_threads(1)

VOC_TRAIN, VOC_TEST = "torch_item14_voc_train", "torch_item14_voc_test"
COCO_TRAIN, COCO_TEST = "torch_item14_coco_train", "torch_item14_coco_test"
VOC = CONFIGS / "PascalVOC-Detection"
OICR = {"loss_cls", "loss_cls_r0", "loss_cls_r1", "loss_cls_r2"}
CASES = {
    "retrain_fast_rcnn": (VOC / "retrain_fast_rcnn_WSR_50_DC5_1x.yaml", TOY,
                          "voc", {"loss_cls", "loss_box_reg"}),
    "cascade_rcnn": (VOC / "cascade_rcnn_WSR_50_DC5_1x.yaml", TOY, "voc",
                     {f"loss_{n}_stage{k}" for n in ("cls", "box_reg")
                      for k in range(3)}),
    "oicr_deform": (VOC / "oicr_WSR_50_DC5_deform_1x.yaml", NARROW_R50, "voc",
                    OICR),
    "fpn_oicr": (CONFIGS / "COCO-Detection" / "fpn_oicr_WSR_50_1x.yaml",
                 TOY + ("MODEL.FPN.OUT_CHANNELS", 16), "coco", OICR),
    "mask_rcnn": (CONFIGS / "Misc" / "mask_rcnn_R_50_FPN_1x.yaml",
                  TOY + ("MODEL.FPN.OUT_CHANNELS", 16,
                         "MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", 4),
                  "coco", {"loss_cls", "loss_box_reg", "loss_mask"}),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("item14_train_net")
    d, voc_train, _ = write_voc(root / "train", TRAIN_SIZES,
                                pvoc.VOC_CLASS_NAMES, split="trainval",
                                seed=41, n_props=90)
    dt, voc_test, _ = write_voc(root / "test", TEST_SIZES,
                                pvoc.VOC_CLASS_NAMES, split="test", seed=42,
                                n_props=90)
    pvoc.register_pascal_voc(VOC_TRAIN, d, "trainval", 2007)
    pvoc.register_pascal_voc(VOC_TEST, dt, "test", 2007)
    train = write_coco_split(root, "coco_train", 6, seed=43)
    test = write_coco_split(root, "coco_test", 2, seed=44)
    pcoco.register_coco_instances(COCO_TRAIN, train[0], train[1])
    pcoco.register_coco_instances(COCO_TEST, test[0], test[1])
    for name in (COCO_TRAIN, COCO_TEST):
        pdata.DatasetCatalog.get(name)       # sets the COCO metadata
    yield root, {"voc": (VOC_TRAIN, VOC_TEST, voc_train, voc_test),
                 "coco": (COCO_TRAIN, COCO_TEST, train[2], test[2])}
    for name in (VOC_TRAIN, VOC_TEST, COCO_TRAIN, COCO_TEST):
        pdata.DatasetCatalog.remove(name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_main_trains_checkpoints_and_evaluates(case, data, tmp_path,
                                               monkeypatch):
    yaml, overrides, kind, names = CASES[case]
    root, splits = data
    train, test, prop_train, prop_test = splits[kind]
    opts = []
    for k, v in zip(overrides[0::2], overrides[1::2]):
        opts += [k, v if isinstance(v, str) else repr(v)]
    opts += ["MODEL.PIXEL_STD", "[57.4, 57.1, 58.4]",
             "MODEL.ROI_BOX_HEAD.DROPOUT", "0.0", "MODEL.WEIGHTS", "",
             "INPUT.MIN_SIZE_TRAIN", "(48, 64)", "INPUT.MAX_SIZE_TRAIN", "90",
             "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "90",
             "INPUT.BUCKETS", "[96]", "TEST.AUG.MIN_SIZES", "(48, 64)",
             "TEST.AUG.MAX_SIZE", "90", "SOLVER.IMS_PER_BATCH", "2",
             "SOLVER.MAX_ITER", "3", "SOLVER.CHECKPOINT_PERIOD", "2",
             "SEED", "0", "TEST.EVAL_PERIOD", "0", "TEST.EVAL_TRAIN", "False",
             "DATASETS.TRAIN", repr((train,)), "DATASETS.TEST", repr((test,)),
             "DATASETS.PROPOSAL_FILES_TRAIN", repr((prop_train,)),
             "DATASETS.PROPOSAL_FILES_TEST", repr((prop_test,)),
             "DATALOADER.NUM_WORKERS", "0", "OUTPUT_DIR", str(tmp_path)]
    losses = []
    make = ptrainer.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(state, batch, seed):
            state, m = step(state, batch, seed)
            losses.append({n: float(v) for n, v in m.items()})
            return state, m
        return run
    monkeypatch.setattr(ptrainer, "make_train_step", recording)
    parse = train_net.argument_parser().parse_args
    results = train_net.main(parse(["--config-file", str(yaml), *opts]),
                             device="cpu")
    assert len(losses) == 3
    for m in losses:
        assert set(m) == names | {"total_loss"}
        assert all(math.isfinite(v) for v in m.values()), m
    assert Checkpointer(str(tmp_path / "checkpoints")).all_steps() == [2, 3]
    keys = ("AP", "AP50", "AP75") if kind == "coco" else ("AP50",)
    tasks = ["bbox", "segm"] if case == "mask_rcnn" else ["bbox"]
    assert [t for t in results[test] if "CorLoc" not in t] == tasks
    for t in tasks:
        for key in keys:
            v = results[test][t][key]
            assert math.isnan(v) or 0 <= v <= 100, (t, key, v)
    if kind == "voc":
        assert 0 <= results[test]["bbox CorLoc"]["CL50"] <= 100
    again = train_net.main(parse(["--config-file", str(yaml), "--eval-only",
                                  "--resume", *opts]), device="cpu")
    assert again.keys() == results.keys()
    assert str(again) == str(results)


def test_mask_rcnn_still_raises():
    """The Mask R-CNN YAML raised item 14 here until the mask arm was
    ported. At its full width it now builds: R50-FPN pooled by ROIAlignV2
    from p2-p5, Fast R-CNN over 80 classes (DAN [1024, 1024]) and the mask
    head (four 3x3 convs of 256 at 14 x 14, the 2x deconv, an 80-class
    predictor). ``FREEZE_AT`` 2 freezes no parameter under the FPN's
    ``bottom_up``: the JAX package's labels freeze only modules directly
    under ``backbone`` (``models/build.py``)."""
    import drn_wsod_torch

    cfg = drn_wsod_torch.get_cfg()
    cfg.merge_from_file(str(CONFIGS / "Misc" / "mask_rcnn_R_50_FPN_1x.yaml"))
    m = drn_wsod_torch.build_model(cfg, device="cpu")
    assert (m.head_type, m.pooler_type, m.mask_on) == (
        "FastRCNN", "ROIAlignV2", True)
    assert [n for n, _ in m.pyramid_strides] == ["p2", "p3", "p4", "p5"]
    assert m.mask_pooler_resolution == 14
    assert m.mask_head.mask_fcn1.weight.shape == (256, 256, 3, 3)
    assert m.mask_head.deconv.weight.shape == (256, 256, 2, 2)
    assert m.mask_head.predictor.weight.shape == (80, 256, 1, 1)
    assert not hasattr(m, "keypoint_head")
    frozen = {n.split(".")[2] for n, p in m.named_parameters()
              if not p.requires_grad and n.startswith("backbone.bottom_up")}
    assert frozen == set()
