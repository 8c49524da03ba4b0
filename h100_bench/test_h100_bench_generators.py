"""The traffic generator and the run's seeds repeat exactly for one seed
and differ across seeds."""

import numpy as np
import torch

from h100_bench import harness
from h100_bench.traffic.generate import make_records
from h100_bench.yardstick import boxes_voc


def _same(a, b):
    if set(a) != set(b):
        return False
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x != y:
            return False
    return True


def test_records_repeat_and_differ():
    mix = harness.load_mix("voc07_train_ms")
    a = make_records(mix, 7, torch.device("cpu"), n=6)
    b = make_records(mix, 7, torch.device("cpu"), n=6)
    c = make_records(mix, 8, torch.device("cpu"), n=6)
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not all(_same(x, y) for x, y in zip(a, c))
    # the sizes are the mix's, the same for every seed
    assert [r["height"] for r in a] == [r["height"] for r in c]


def test_records_follow_the_mix():
    mix = harness.load_mix("voc07_test_tta")
    recs = make_records(mix, 3, torch.device("cpu"), n=20)
    lo, hi = mix["proposals"]
    for r in recs:
        h, w = r["height"], r["width"]
        assert r["image"].shape == (h, w, 3) and r["image"].dtype == np.uint8
        assert max(h, w) <= 500
        assert lo <= len(r["proposal_boxes"]) <= hi
        logits = r["proposal_objectness_logits"]
        assert np.all(np.diff(logits) <= 0)
        b = r["proposal_boxes"]
        assert b[:, 0].min() >= 0 and b[:, 2].max() <= w
        assert b[:, 1].min() >= 0 and b[:, 3].max() <= h
        assert r["annotations"]


def test_seeds_of_large_numbers():
    a = harness.derive_seeds(2 ** 31 + 12345)
    assert a == harness.derive_seeds(2 ** 31 + 12345)
    assert a != harness.derive_seeds(2 ** 31 + 12346)


def test_boxes_voc_repeats():
    x = boxes_voc(np.random.default_rng(5), 1, 100, 704)
    y = boxes_voc(np.random.default_rng(5), 1, 100, 704)
    assert np.array_equal(x, y)
    assert np.median(x[0, :, 2] - x[0, :, 0]) > 30


def test_weights_repeat_and_differ():
    from h100_bench.reference import arch as arch_lib

    arch = arch_lib.from_config(harness.load_config(
        "oicr_r50", {"MODEL.RESNETS.STEM_OUT_CHANNELS": 8,
                     "MODEL.RESNETS.RES2_OUT_CHANNELS": 16,
                     "MODEL.RESNETS.WIDTH_PER_GROUP": 4,
                     "MODEL.ROI_BOX_HEAD.DAN_DIM": [16, 16]})["merged"])
    leaves = arch_lib.leaves(arch)
    a = harness.make_weights(leaves, 1, torch.device("cpu"))
    b = harness.make_weights(leaves, 1, torch.device("cpu"))
    c = harness.make_weights(leaves, 2, torch.device("cpu"))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["box_head.fc1.weight"], c["box_head.fc1.weight"])
