"""Default configuration tree.

The port's own copy of the JAX package's defaults
(``drn_wsod_tpu/config/defaults.py``): the same keys and values, so one YAML
file merges to the same tree in both packages (a test holds the two
``to_dict()`` results equal). Keys that only the JAX package reads keep their
values here so that the trees stay equal.
"""

from .node import CfgNode


def get_cfg() -> CfgNode:
    """Return a fresh copy of the default config."""
    _C = CfgNode()

    _C.VERSION = 2
    _C.OUTPUT_DIR = "./output"
    # period (iters) for training visualizations (pgt dumps / TB images);
    # 0 disables (reference detectron2 _C.VIS_PERIOD)
    _C.VIS_PERIOD = 0
    _C.SEED = -1

    # ------------------------------------------------------------------ model
    _C.MODEL = CfgNode()
    _C.MODEL.META_ARCHITECTURE = "GeneralizedRCNNWSL"
    _C.MODEL.WEIGHTS = ""
    _C.MODEL.MASK_ON = False
    _C.MODEL.KEYPOINT_ON = False
    _C.MODEL.ROI_KEYPOINT_HEAD = CfgNode()
    _C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
    _C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.ROI_MASK_HEAD = CfgNode()
    _C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    _C.MODEL.LOAD_PROPOSALS = True
    # Caffe2-era BGR means; must match reference for weight-import parity
    # (reference: projects/WSL/configs/PascalVOC-Detection/oicr_WSR_50_DC5_1x.yaml).
    _C.MODEL.PIXEL_MEAN = [102.9801, 115.9465, 122.7717]
    _C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
    # Compute dtype for backbone/head matmuls ("bfloat16" or "float32").
    _C.MODEL.DTYPE = "bfloat16"

    _C.MODEL.BACKBONE = CfgNode()
    _C.MODEL.BACKBONE.NAME = "build_ws_resnet_backbone"
    # Freeze stem + stages <= FREEZE_AT (5 == whole tower, the WSOD default).
    _C.MODEL.BACKBONE.FREEZE_AT = 5

    _C.MODEL.RESNETS = CfgNode()
    _C.MODEL.RESNETS.DEPTH = 50
    _C.MODEL.RESNETS.OUT_FEATURES = ["res5"]
    _C.MODEL.RESNETS.NUM_GROUPS = 1
    _C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    _C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    _C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    _C.MODEL.RESNETS.STRIDE_IN_1X1 = True
    _C.MODEL.RESNETS.RES5_DILATION = 2
    _C.MODEL.RESNETS.NORM = "FrozenBN"
    # deformable bottlenecks (reference defaults.py:488-493): one flag per
    # stage res2..res5; v2 (modulated) toggled globally
    _C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
    _C.MODEL.RESNETS.DEFORM_MODULATED = False
    _C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1

    _C.MODEL.FPN = CfgNode()
    _C.MODEL.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    _C.MODEL.FPN.OUT_CHANNELS = 256

    _C.MODEL.VGG = CfgNode()
    _C.MODEL.VGG.DEPTH = 16
    _C.MODEL.VGG.OUT_FEATURES = ["plain5"]
    _C.MODEL.VGG.CONV5_DILATION = 2

    _C.MODEL.PROPOSAL_GENERATOR = CfgNode()
    _C.MODEL.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    _C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 20

    _C.MODEL.ROI_HEADS = CfgNode()
    _C.MODEL.ROI_HEADS.NAME = "OICRROIHeads"
    _C.MODEL.ROI_HEADS.NUM_CLASSES = 20
    _C.MODEL.ROI_HEADS.IN_FEATURES = ["res5"]
    _C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    _C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    # WSOD keeps every proposal (reference forces no subsampling,
    # projects/WSL/wsl/modeling/roi_heads/roi_heads.py:245-246). Here this is
    # the static padded proposal count per image.
    _C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 4096
    _C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    _C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 1e-5
    _C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.3
    _C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = False

    _C.MODEL.ROI_BOX_HEAD = CfgNode()
    _C.MODEL.ROI_BOX_HEAD.NAME = "DiscriminativeAdaptionNeck"
    _C.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    _C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    _C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    _C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    _C.MODEL.ROI_BOX_HEAD.DAN_DIM = [4096, 4096]
    _C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    _C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    _C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIPool"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
    _C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
    _C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
    _C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    _C.MODEL.ROI_BOX_HEAD.DROPOUT = 0.5
    # The forward-only RoIPool kernel with the (objectness + 1) * mask scale
    # fused in. False selects the differentiable pool, which the port does
    # not have yet.
    _C.MODEL.ROI_BOX_HEAD.USE_PALLAS_POOLER = True

    # PanopticFPN + semantic head (reference MODEL.SEM_SEG_HEAD /
    # MODEL.PANOPTIC_FPN config nodes).
    _C.MODEL.SEM_SEG_HEAD = CfgNode()
    _C.MODEL.SEM_SEG_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    _C.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
    _C.MODEL.SEM_SEG_HEAD.CONVS_DIM = 128
    _C.MODEL.SEM_SEG_HEAD.COMMON_STRIDE = 4
    _C.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = 255
    _C.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 1.0
    # WSJDS constrain-to-boundary: CRF-refined pseudo targets + weighted KL
    # during training and CRF refinement at inference (reference WSL
    # MODEL.SEM_SEG_HEAD.CONSTRAINT, seg_heads.py:92,140-160)
    _C.MODEL.SEM_SEG_HEAD.CONSTRAINT = False
    _C.MODEL.PANOPTIC_FPN = CfgNode()
    _C.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT = 1.0
    _C.MODEL.PANOPTIC_FPN.COMBINE = CfgNode()
    _C.MODEL.PANOPTIC_FPN.COMBINE.ENABLED = True
    _C.MODEL.PANOPTIC_FPN.COMBINE.OVERLAP_THRESH = 0.5
    _C.MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT = 4096
    _C.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.5

    # RetinaNet (reference detectron2/config/defaults.py MODEL.RETINANET +
    # MODEL.ANCHOR_GENERATOR; meta_arch/retinanet.py).
    _C.MODEL.RETINANET = CfgNode()
    _C.MODEL.RETINANET.NUM_CLASSES = 80
    _C.MODEL.RETINANET.IN_FEATURES = ["p3", "p4", "p5", "p6"]
    _C.MODEL.RETINANET.NUM_CONVS = 4
    _C.MODEL.RETINANET.IOU_THRESHOLDS = [0.4, 0.5]
    _C.MODEL.RETINANET.IOU_LABELS = [0, -1, 1]
    _C.MODEL.RETINANET.PRIOR_PROB = 0.01
    _C.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
    _C.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 1000
    _C.MODEL.RETINANET.NMS_THRESH_TEST = 0.5
    _C.MODEL.RETINANET.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
    _C.MODEL.RETINANET.FOCAL_LOSS_GAMMA = 2.0
    _C.MODEL.RETINANET.FOCAL_LOSS_ALPHA = 0.25
    _C.MODEL.RETINANET.SMOOTH_L1_LOSS_BETA = 0.1

    _C.MODEL.ANCHOR_GENERATOR = CfgNode()
    _C.MODEL.ANCHOR_GENERATOR.SIZES = [
        [32.0, 40.0, 51.0], [64.0, 81.0, 102.0],
        [128.0, 161.0, 203.0], [256.0, 323.0, 406.0]]
    _C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]

    # Cascade R-CNN (reference detectron2/modeling/roi_heads/cascade_rcnn.py
    # + configs/Misc/cascade_*.yaml): per-stage box-transform weights and
    # matcher IoU thresholds.
    _C.MODEL.ROI_BOX_CASCADE_HEAD = CfgNode()
    _C.MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS = (
        (10.0, 10.0, 5.0, 5.0),
        (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0),
    )
    _C.MODEL.ROI_BOX_CASCADE_HEAD.IOUS = (0.5, 0.6, 0.7)

    # ------------------------------------------------------------------- wsl
    # Reference: projects/WSL/wsl/config/defaults.py:7-43
    _C.WSL = CfgNode()
    _C.WSL.ITER_SIZE = 1
    _C.WSL.MEAN_LOSS = True
    _C.WSL.VIS_TEST = False
    _C.WSL.USE_OBN = True
    _C.WSL.REFINE_NUM = 3
    _C.WSL.REFINE_REG = [False, False, False]
    _C.WSL.CSC_MAX_ITER = 35000
    _C.WSL.PCL_GRAPH_IOU = 0.4
    _C.WSL.PCL_MAX_PC_NUM = 5

    # ------------------------------------------------------------------ input
    _C.INPUT = CfgNode()
    _C.INPUT.MIN_SIZE_TRAIN = (480, 576, 688, 864, 1200)
    _C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    _C.INPUT.MAX_SIZE_TRAIN = 2000
    _C.INPUT.MIN_SIZE_TEST = 688
    _C.INPUT.MAX_SIZE_TEST = 4000
    _C.INPUT.RANDOM_FLIP = "horizontal"
    _C.INPUT.CROP = CfgNode()
    _C.INPUT.CROP.ENABLED = False
    _C.INPUT.CROP.TYPE = "relative_range"
    _C.INPUT.CROP.SIZE = [0.9, 0.9]
    _C.INPUT.FORMAT = "BGR"
    # Static-shape buckets: images are padded up to (bucket, bucket).
    _C.INPUT.SIZE_DIVISIBILITY = 32
    _C.INPUT.BUCKETS = [512, 704, 896, 1216]

    # ---------------------------------------------------------------- datasets
    _C.DATASETS = CfgNode()
    _C.DATASETS.TRAIN = ("voc_2007_train", "voc_2007_val")
    _C.DATASETS.TEST = ("voc_2007_test",)
    _C.DATASETS.VAL = ()
    _C.DATASETS.PROPOSAL_FILES_TRAIN = ()
    _C.DATASETS.PROPOSAL_FILES_TEST = ()
    _C.DATASETS.PROPOSAL_FILES_VAL = ()
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 4000
    _C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 4000
    # Static slot count for padded instance GT (supervised retraining).
    _C.DATASETS.MAX_GT_PER_IMAGE = 100

    # -------------------------------------------------------------- dataloader
    _C.DATALOADER = CfgNode()
    _C.DATALOADER.NUM_WORKERS = 4
    _C.DATALOADER.ASPECT_RATIO_GROUPING = True
    _C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
    # for RepeatFactorTrainingSampler (reference defaults.py): oversample
    # images whose rarest category has frequency below this threshold
    _C.DATALOADER.REPEAT_THRESHOLD = 0.0
    _C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True
    _C.DATALOADER.PREFETCH = 2

    # ------------------------------------------------------------------ solver
    _C.SOLVER = CfgNode()
    _C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
    _C.SOLVER.MAX_ITER = 50000
    _C.SOLVER.BASE_LR = 0.01
    _C.SOLVER.MOMENTUM = 0.9
    # "bfloat16" stores the momentum buffers in bf16 (the reference trains
    # f32; the deviation is opt-in)
    _C.SOLVER.MOMENTUM_DTYPE = "float32"
    _C.SOLVER.NESTEROV = False
    _C.SOLVER.WEIGHT_DECAY = 0.0005
    _C.SOLVER.WEIGHT_DECAY_NORM = 0.0
    _C.SOLVER.WEIGHT_DECAY_BIAS = 0.0
    _C.SOLVER.GAMMA = 0.1
    _C.SOLVER.STEPS = (35000, 45000)
    # When non-zero, auto_scale_workers() rescales batch/LR/iters to the
    # actual chip count (reference DefaultTrainer.auto_scale_workers)
    _C.SOLVER.REFERENCE_WORLD_SIZE = 0
    _C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    _C.SOLVER.WARMUP_ITERS = 0
    _C.SOLVER.WARMUP_METHOD = "linear"
    _C.SOLVER.BIAS_LR_FACTOR = 2.0
    _C.SOLVER.CHECKPOINT_PERIOD = 5000
    _C.SOLVER.IMS_PER_BATCH = 4
    _C.SOLVER.CLIP_GRADIENTS = CfgNode()
    _C.SOLVER.CLIP_GRADIENTS.ENABLED = False
    _C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
    _C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    _C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
    # Train steps per dispatch in the JAX trainer (read by it only).
    _C.SOLVER.STEPS_PER_DISPATCH = 20

    # -------------------------------------------------------------------- test
    _C.TEST = CfgNode()
    # PreciseBN (reference defaults.py TEST.PRECISE_BN): recompute true BN
    # stats before eval; automatic for NORM="BN" backbones
    _C.TEST.PRECISE_BN = CfgNode()
    _C.TEST.PRECISE_BN.ENABLED = False
    _C.TEST.PRECISE_BN.NUM_ITER = 200
    _C.TEST.EVAL_PERIOD = 0
    _C.TEST.EVAL_TRAIN = True
    _C.TEST.DETECTIONS_PER_IMAGE = 100
    _C.TEST.AUG = CfgNode()
    _C.TEST.AUG.ENABLED = False
    _C.TEST.AUG.MIN_SIZES = (480, 576, 672, 768, 864, 960, 1056, 1152)
    _C.TEST.AUG.MAX_SIZE = 4000
    _C.TEST.AUG.FLIP = True
    # build TTA views (resize/flip/pad) on device from the raw image instead
    # of shipping per-view f32 buffers from the host (new key, no reference
    # analog; see tta.py:_device_view_batch)
    _C.TEST.AUG.DEVICE_VIEWS = True
    _C.TEST.EXPECTED_RESULTS = []

    # ---------------------------------------------------------------- parallel
    # Device mesh of the JAX package's data/model parallel launcher.
    _C.PARALLEL = CfgNode()
    _C.PARALLEL.MESH_AXES = ["data"]
    _C.PARALLEL.MESH_SHAPE = [-1]  # -1: use all visible devices on that axis

    return _C

