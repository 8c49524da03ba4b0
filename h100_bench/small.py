"""The small sizes at which the CPU tests run whole cells: narrow widths,
few proposals, 48-96 px images, so that a run takes seconds on the CPU.
Every other value is the cell's."""

SMALL = {
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 8,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 4,
    "MODEL.ROI_BOX_HEAD.DAN_DIM": [32, 32],
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 64,
    "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN": 64,
    "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST": 64,
    "INPUT.MIN_SIZE_TRAIN": [48, 64],
    "INPUT.MAX_SIZE_TRAIN": 96,
    "INPUT.BUCKETS": [64, 96],
    "TEST.AUG.MIN_SIZES": [48, 64],
    "TEST.AUG.MAX_SIZE": 96,
}
RECORDS = 12
