"""The frozen copies equal the program's functions today: K1's bound and
cell count, the bucket rule and the TTA's views."""

import numpy as np
import torch

from h100_bench import yardstick


def test_bound_equals_the_programs():
    from drn_wsod_torch.ops import roi_pool as prog

    rs = np.random.RandomState(0)
    for B, S, C in ((2, 88, 2048), (4, 191, 2048), (3, 17, 64)):
        boxes = torch.from_numpy(yardstick.boxes_voc(rs, B, 500, S * 8))
        feats = torch.empty(B, S, S, C, dtype=torch.bfloat16)
        scale = torch.empty(B, 500)
        out = torch.empty(B, 500, 7, 7, C, dtype=torch.bfloat16)
        assert yardstick.roi_pool_bound(feats, boxes, scale, out, 1 / 8) == \
            prog.roi_pool_bound(feats, boxes, scale, out, 1 / 8)
        assert torch.equal(yardstick.bin_cells(boxes, 1 / 8, S, S),
                           prog.bin_cells(boxes, 1 / 8, S, S))


def test_bucket_and_views_equal_the_programs():
    from drn_wsod_torch.data.mapper import pick_bucket
    from drn_wsod_torch.tta import enumerate_views

    buckets = (512, 704, 896, 1216)
    for h, w in ((375, 500), (500, 375), (333, 500), (500, 500), (211, 500)):
        for s in (480, 672, 1152, 1216):
            assert yardstick.pick_bucket(h * s // 375, w * s // 375,
                                         buckets) == \
                pick_bucket(h * s // 375, w * s // 375, buckets)
        mins = (480, 576, 672, 768, 864, 960, 1056, 1152)
        assert yardstick.enumerate_views((h, w), mins, 4000, True) == \
            enumerate_views((h, w), mins, 4000, True)


def test_train_buckets_cover_the_loaders():
    """Every bucket the program's mapper plans for the mix's sizes lies in
    the set the harness warms."""
    from drn_wsod_torch.config import get_cfg
    from drn_wsod_torch.data.mapper import DatasetMapper

    from h100_bench import harness

    conf = harness.load_config("oicr_r50")
    cfg = get_cfg()
    from drn_wsod_torch.config import CfgNode
    cfg.merge_from_other(CfgNode(conf["merged"]))
    mapper = DatasetMapper(cfg, True)
    sizes = [(375, 500), (500, 375), (333, 500), (500, 333), (500, 500),
             (211, 500)]
    warmed = set(yardstick.train_buckets(
        sizes, cfg.INPUT.MIN_SIZE_TRAIN, cfg.INPUT.MAX_SIZE_TRAIN,
        tuple(cfg.INPUT.CROP.SIZE), cfg.INPUT.BUCKETS))
    for i in range(400):
        h, w = sizes[i % len(sizes)]
        b = mapper.plan_bucket({"height": h, "width": w},
                               np.random.RandomState(i))
        assert b in warmed, (h, w, b)
