"""The port's training data path against the JAX package's, on the CPU:
the resize against Pillow (the JAX package's ``ResizeTransform`` is
Pillow), every transform and augmentation and ``apply_augmentations`` on
the same rng seeds, ``transform_proposals``, ``DatasetMapper`` (train and
test, with ``plan_bucket`` against the decoded bucket), the first 12
batches of ``TrainLoader`` (0 and 3 workers, and the repeat-factor
sampler) and ``EvalLoader``. Everything must be equal: host numpy on both
sides, and pixels bit for bit."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from drn_wsod_torch import data as pdata
from drn_wsod_torch.data import loader as ploader
from drn_wsod_torch.data import transforms as pT
from drn_wsod_torch.data.datasets import voc as pvoc
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data import loader as jloader
from drn_wsod_tpu.data import transforms as jT
from drn_wsod_tpu.data.datasets import voc as jvoc
from test_torch_common import cfg_pair, write_voc

SIZES = [(40, 56), (64, 48), (33, 70), (50, 50), (61, 45), (47, 66),
         (38, 38)]
# the flagship's augmentations (crop 0.9-1.0, multi-scale, flip) at a toy
# scale, two buckets plus sizes rounded up beyond them
OPTS = ("INPUT.MIN_SIZE_TRAIN", (40, 56, 72, 88), "INPUT.MAX_SIZE_TRAIN", 120,
        "INPUT.MIN_SIZE_TEST", 48, "INPUT.MAX_SIZE_TEST", 100,
        "INPUT.BUCKETS", [64, 96], "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
        "DATASETS.MAX_GT_PER_IMAGE", 4, "SOLVER.IMS_PER_BATCH", 2,
        "DATALOADER.PREFETCH", 0)
NAME = "torch_train_data_test"
FLAGSHIP_SHORT_SIDES = tuple(range(480, 1217, 32))


def pillow_resize(img, nh, nw):
    return np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 90), w=st.integers(1, 90),
       fy=st.floats(0.2, 4.0), fx=st.floats(0.2, 4.0),
       keep=st.sampled_from(["none", "h", "w"]), channels=st.sampled_from(
           [3, 0]), seed=st.integers(0, 2 ** 16))
def test_resize_equals_pillow(h, w, fy, fx, keep, channels, seed):
    """Up and down by 0.2-4x, odd sides, one side unchanged, RGB and
    grayscale; the JAX package's resize (Pillow) too."""
    nh = h if keep == "h" else max(1, int(round(h * fy)))
    nw = w if keep == "w" else max(1, int(round(w * fx)))
    shape = (h, w, channels) if channels else (h, w)
    img = np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)
    got = pT.resize_bilinear(img, nh, nw)
    assert got.dtype == np.uint8 and got.shape == (nh, nw) + shape[2:]
    np.testing.assert_array_equal(got, pillow_resize(img, nh, nw))
    if channels:
        np.testing.assert_array_equal(
            pT.ResizeTransform(h, w, nh, nw).apply_image(img),
            jT.ResizeTransform(h, w, nh, nw).apply_image(img))


@pytest.mark.parametrize("hw", [(375, 500), (500, 333), (281, 500)],
                         ids=["500x375", "333x500", "500x281"])
def test_resize_flagship_short_sides_equal_pillow(hw):
    """Every MIN_SIZE_TRAIN of the flagship (480-1216) under MAX_SIZE_TRAIN
    2000, from VOC-sized images of smooth content."""
    rs = np.random.RandomState(hw[0])
    base = rs.randint(0, 256, (hw[0] // 8 + 1, hw[1] // 8 + 1, 3))
    img = pillow_resize(base.astype(np.uint8), *hw)
    for size in FLAGSHIP_SHORT_SIDES:
        nh, nw = pT.ResizeShortestEdge.target_size(*hw, size, 2000)
        np.testing.assert_array_equal(pT.resize_bilinear(img, nh, nw),
                                      pillow_resize(img, nh, nw),
                                      err_msg=str((size, nh, nw)))


def _pair(tfm_p, tfm_j, img, boxes):
    np.testing.assert_array_equal(tfm_p.apply_image(img),
                                  tfm_j.apply_image(img))
    got, want = tfm_p.apply_box(boxes), tfm_j.apply_box(boxes)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert tfm_p.output_size(img.shape[:2]) == \
        tfm_j.output_size(img.shape[:2])


def test_transforms_equal():
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    boxes = rs.uniform(0, 37, (30, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    for name, args in (("NoOpTransform", ()), ("HFlipTransform", (53,)),
                       ("CropTransform", (3, 5, 40, 29, 53, 37)),
                       ("ResizeTransform", (37, 53, 61, 88))):
        _pair(getattr(pT, name)(*args), getattr(jT, name)(*args), img, boxes)
    lst = [pT.CropTransform(3, 5, 40, 29), pT.ResizeTransform(29, 40, 45, 62),
           pT.HFlipTransform(62)]
    jlst = [jT.CropTransform(3, 5, 40, 29), jT.ResizeTransform(29, 40, 45, 62),
            jT.HFlipTransform(62)]
    np.testing.assert_array_equal(pT.TransformList(lst).apply_image(img),
                                  jT.TransformList(jlst).apply_image(img))
    np.testing.assert_array_equal(pT.TransformList(lst).apply_box(boxes),
                                  jT.TransformList(jlst).apply_box(boxes))
    # the inverse of resize and flip (TTA's use); a crop has none
    inv_p = pT.TransformList(lst[1:]).inverse()
    inv_j = jT.TransformList(jlst[1:]).inverse()
    np.testing.assert_array_equal(inv_p.apply_box(boxes),
                                  inv_j.apply_box(boxes))
    with pytest.raises(NotImplementedError):
        lst[0].inverse()
    assert (pT.TransformList(lst[:1]) + lst[2]).transforms == \
        [lst[0], lst[2]]


AUGS = [("ResizeShortestEdge", ((40, 56, 72), 100, "choice")),
        ("ResizeShortestEdge", ((40, 72), 90, "range")),
        ("ResizeShortestEdge", ((0,), 90, "choice")),
        ("RandomFlip", (0.5,)),
        ("RandomCrop", ("relative_range", (0.9, 0.9))),
        ("RandomCrop", ("relative", (0.5, 0.7))),
        ("RandomCrop", ("absolute", (30, 80)))]


@pytest.mark.parametrize("name,args", AUGS,
                         ids=[f"{n}-{a[-1]}" for n, a in AUGS])
def test_augmentations_equal(name, args):
    """The same rng seed draws the same transform, and the rng is left in
    the same state."""
    rs = np.random.RandomState(5)
    img = rs.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    boxes = rs.uniform(0, 30, (12, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    kinds = set()
    for seed in range(12):
        rp, rj = np.random.RandomState(seed), np.random.RandomState(seed)
        tp = getattr(pT, name)(*args).get_transform(img, rp)
        tj = getattr(jT, name)(*args).get_transform(img, rj)
        assert type(tp).__name__ == type(tj).__name__
        assert {k: v for k, v in vars(tp).items()} == vars(tj)
        _pair(tp, tj, img, boxes)
        assert rp.randint(2 ** 31) == rj.randint(2 ** 31)
        kinds.add(type(tp).__name__)
    if name == "RandomFlip":
        assert kinds == {"HFlipTransform", "NoOpTransform"}


def test_apply_augmentations_equal():
    """The flagship's train augmentations (crop, multi-scale resize, flip)
    in order, on the same seeds."""
    rs = np.random.RandomState(6)
    img = rs.randint(0, 256, (45, 61, 3)).astype(np.uint8)
    boxes = rs.uniform(0, 40, (25, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    for seed in range(8):
        outs = []
        for T in (pT, jT):
            augs = [T.RandomCrop("relative_range", (0.9, 0.9)),
                    T.ResizeShortestEdge((40, 56, 72), 100, "choice"),
                    T.RandomFlip(0.5)]
            image, tfms = T.apply_augmentations(
                augs, img, np.random.RandomState(seed))
            outs.append((image, tfms.apply_box(boxes),
                         [type(t).__name__ for t in tfms.transforms]))
        (gi, gb, gn), (wi, wb, wn) = outs
        assert gn == wn
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gb, wb)


def assert_samples_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    d, prop_file, images = write_voc(root, SIZES, pvoc.VOC_CLASS_NAMES,
                                     split="trainval", seed=7, n_props=90)
    pvoc.register_pascal_voc(NAME, d, "trainval", 2007)
    jvoc.register_pascal_voc(NAME, d, "trainval", 2007)
    records = pdata.get_detection_dataset_dicts([NAME], [prop_file],
                                                filter_empty=False)
    yield d, prop_file, images, records
    pdata.DatasetCatalog.remove(NAME)
    jdata.DatasetCatalog.remove(NAME)


def test_transform_proposals_equal(voc):
    records = voc[3]
    for i, r in enumerate(records):
        rs = np.random.RandomState(i)
        h, w = SIZES[i]
        tp = pT.TransformList([pT.CropTransform(2, 1, w - 5, h - 3),
                               pT.ResizeTransform(h - 3, w - 5, 2 * h, 2 * w),
                               pT.HFlipTransform(2 * w)])
        tj = jT.TransformList([jT.CropTransform(2, 1, w - 5, h - 3),
                               jT.ResizeTransform(h - 3, w - 5, 2 * h, 2 * w),
                               jT.HFlipTransform(2 * w)])
        for min_size, topk in ((0.0, 4000), (3.0, 40), (rs.uniform(1, 9), 7)):
            got = pdata.transform_proposals(r, (2 * h, 2 * w), tp,
                                            min_box_size=min_size, topk=topk)
            want = jdata.proposals.transform_proposals(
                {k: (v.copy() if isinstance(v, np.ndarray) else v)
                 for k, v in r.items()}, (2 * h, 2 * w), tj,
                min_box_size=min_size, topk=topk)
            for g, wv in zip(got, want):
                assert g.dtype == wv.dtype
                np.testing.assert_array_equal(g, wv)
        # no transform: clip, dedup (the pickle holds duplicates), top-k
        got = pdata.transform_proposals(r, (h, w), None)
        want = jdata.proposals.transform_proposals(
            {k: (v.copy() if isinstance(v, np.ndarray) else v)
             for k, v in r.items()}, (h, w), None)
        np.testing.assert_array_equal(got[0], want[0])
        assert len(got[0]) < len(r["proposal_boxes"])


def _packed(records, images):
    """The records as packed shards hold them: decoded BGR pixels."""
    return [{**r, "image": np.ascontiguousarray(
        images[r["image_id"]][:, :, ::-1])} for r in records]


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("source", ["jpeg", "packed"])
def test_mapper_equal(voc, is_train, source):
    _, _, images, records = voc
    if source == "packed":
        records = _packed(records, images)
    jc, pc = cfg_pair(*OPTS)
    pm = pdata.DatasetMapper(pc, is_train=is_train)
    jm = jdata.DatasetMapper(jc, is_train=is_train)
    buckets = set()
    for seed in range(3):
        for i, r in enumerate(records):
            got = pm(r, np.random.RandomState(seed * 31 + i), dataset_index=i)
            want = jm(r, np.random.RandomState(seed * 31 + i),
                      dataset_index=i)
            assert_samples_equal(got, want)
            assert got["image"].dtype == np.uint8
            buckets.add(got["_bucket"])
            if "height" not in r and "image" not in r:
                continue          # no XML: no size without a decode
            plan = pm.plan_bucket(r, np.random.RandomState(seed * 31 + i))
            assert plan == got["_bucket"] == jm.plan_bucket(
                r, np.random.RandomState(seed * 31 + i))
    if is_train:
        assert buckets >= {64, 96} and max(buckets) > 96


def test_mapper_refuses_unported_arms(tmp_path):
    """No arm of the mapper raises now. The semantic-segmentation arm
    raised item 15 here until it was ported: the (bucket, bucket) int32
    ``sem_seg`` canvas (``IGNORE_VALUE`` outside the image) and every other
    field equal the JAX mapper's in training and test, on gray and palette
    label PNGs (the palette's indices are the labels) resized by nearest
    sampling and flipped, and ``EvalLoader``'s batches of them are the JAX
    loader's. The mask arm raised item 14 here until it was
    ported: with ``MASK_ON`` the mapper's (G, bucket, bucket) uint8
    ``gt_masks`` now equal the JAX mapper's float32 ones in training and
    test (polygons of COCO-format records, some of two polygons, resized
    and flipped), and ``EvalLoader`` re-pads them to the batch's bucket as
    the JAX loader does."""
    from drn_wsod_torch.tools.make_mask_fixtures import (coco_records,
                                                         synthetic_coco)

    jc, pc = cfg_pair(*OPTS, "MODEL.SEM_SEG_HEAD.IGNORE_VALUE", 250)
    records = coco_records(synthetic_coco(5, 6, num_classes=20))
    rs = np.random.RandomState(0)
    for i, r in enumerate(records):
        labels = rs.randint(0, 60, (r["height"] // 8, r["width"] // 8))
        labels = np.kron(labels, np.ones((8, 8), int))[:r["height"],
                                                       :r["width"]]
        im = Image.fromarray(labels.astype(np.uint8), "L" if i % 2 else "P")
        if i % 2 == 0:
            im.putpalette(rs.randint(0, 256, 768).tolist())
        r["sem_seg_file_name"] = str(tmp_path / f"sem{i}.png")
        im.save(r["sem_seg_file_name"])
    for is_train in (True, False):
        pm = pdata.DatasetMapper(pc, is_train=is_train)
        jm = jdata.DatasetMapper(jc, is_train=is_train)
        for i, r in enumerate(records):
            got = pm(dict(r), np.random.RandomState(i))
            want = jm(dict(r), np.random.RandomState(i))
            assert_samples_equal(got, want)
            h, w = got["image_hw"]
            assert got["sem_seg"].dtype == np.int32
            assert (got["sem_seg"][h:] == 250).all()
            assert (got["sem_seg"][:h, :w] < 60).all()
    got = list(pdata.EvalLoader(records, pm, batch_size=3, prefetch=0))
    want = list(jdata.EvalLoader(records, jm, batch_size=3, prefetch=0))
    for (g, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(g.sem_seg.numpy(),
                                      np.asarray(w.sem_seg))

    jc, pc = cfg_pair(*OPTS, "MODEL.MASK_ON", True)
    records = coco_records(synthetic_coco(3, 6, num_classes=20))
    for is_train in (True, False):
        pm = pdata.DatasetMapper(pc, is_train=is_train)
        jm = jdata.DatasetMapper(jc, is_train=is_train)
        for i, r in enumerate(records):
            got = pm(dict(r), np.random.RandomState(i))
            want = jm(dict(r), np.random.RandomState(i))
            assert got["gt_masks"].dtype == np.uint8
            assert got["gt_masks"].shape == (4, got["_bucket"],
                                             got["_bucket"])
            np.testing.assert_array_equal(got["gt_masks"], want["gt_masks"])
            n = min(len([a for a in r["annotations"] if not a["iscrowd"]]),
                    4)
            assert got["gt_masks"][:n].any((1, 2)).all()
    got = list(pdata.EvalLoader(records, pm, batch_size=3, prefetch=0))
    want = list(jdata.EvalLoader(records, jm, batch_size=3, prefetch=0))
    for (g, _), (w, _) in zip(got, want):
        assert g.gt_masks.dtype == torch.uint8
        np.testing.assert_array_equal(g.gt_masks.numpy(),
                                      np.asarray(w.gt_masks))


def _assert_batches_equal(got, want):
    gd = got.tensors()
    wd = {k: v for k, v in vars(want).items() if v is not None}
    assert gd.keys() == wd.keys()
    for k, g in gd.items():
        assert g.device.type == "cpu", k
        w = np.asarray(wd[k])
        assert g.numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("workers,sampler", [(0, "TrainingSampler"),
                                             (3, "TrainingSampler"),
                                             (0, "RepeatFactor")])
def test_train_loader_equal(voc, workers, sampler):
    """The first 12 batches, one for one: images, proposals, GT and the
    dataset indices, with the buckets mixed."""
    _, prop_file, images, _ = voc
    opts = OPTS + ("DATASETS.TRAIN", (NAME,),
                   "DATASETS.PROPOSAL_FILES_TRAIN", (prop_file,),
                   "DATALOADER.NUM_WORKERS", workers, "SEED", 3,
                   "DATALOADER.FILTER_EMPTY_ANNOTATIONS", True)
    if sampler == "RepeatFactor":
        opts += ("DATALOADER.SAMPLER_TRAIN", "RepeatFactorTrainingSampler",
                 "DATALOADER.REPEAT_THRESHOLD", 0.5)
    jc, pc = cfg_pair(*opts)
    got_it = iter(pdata.build_detection_train_loader(
        pc, pdata.DatasetMapper(pc, is_train=True)))
    want_it = iter(jdata.build_detection_train_loader(
        jc, jdata.DatasetMapper(jc, is_train=True)))
    shapes = set()
    for _ in range(12):
        got, want = next(got_it), next(want_it)
        _assert_batches_equal(got, want)
        shapes.add(tuple(got.image.shape))
    assert len(shapes) > 1


def test_repeat_factors_equal(voc):
    records = voc[3]
    for thresh in (0.0, 0.3, 0.9):
        np.testing.assert_array_equal(
            ploader.repeat_factors_from_category_frequency(records, thresh),
            jloader.repeat_factors_from_category_frequency(records, thresh))


@pytest.mark.parametrize("batch_size", [1, 3])
def test_eval_loader_equal(voc, batch_size):
    """Dataset order, each batch padded to its largest bucket, the last
    one filled with its last sample. The port keeps the re-padded images
    uint8 where the JAX package makes them float32 (the values agree)."""
    _, prop_file, _, _ = voc
    jc, pc = cfg_pair(*OPTS, "DATASETS.TEST", (NAME,),
                      "DATASETS.PROPOSAL_FILES_TEST", (prop_file,))
    got = list(pdata.build_detection_test_loader(
        pc, NAME, pdata.DatasetMapper(pc, False), batch_size=batch_size))
    want = list(jdata.build_detection_test_loader(
        jc, NAME, jdata.DatasetMapper(jc, False), batch_size=batch_size))
    assert [n for _, n in got] == [n for _, n in want]
    assert sum(n for _, n in got) == len(SIZES)
    for (g, _), (w, _) in zip(got, want):
        assert g.image.dtype == torch.uint8
        w = w.replace(image=np.asarray(w.image).astype(np.uint8))
        _assert_batches_equal(g, w)


def test_collate_yields_cpu_tensors(voc):
    _, _, images, records = voc
    _, pc = cfg_pair(*OPTS)
    mapper = pdata.DatasetMapper(pc, is_train=False)
    samples = [mapper(r, np.random.RandomState(0), i)
               for i, r in enumerate(_packed(records[:1] * 2, images))]
    batch = ploader._collate(samples)
    for k, t in batch.tensors().items():
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu", k
    assert batch.image.dtype == torch.uint8
    assert batch.gt_boxes.shape == (2, 4, 4)


def test_loaders_refuse_several_processes(voc):
    """Several processes are no longer refused: each rank's train loader
    yields its slice of every global batch (together the global batch,
    rank-major), and the eval loader runs over ``records[rank::2]``; an
    IMS_PER_BATCH the processes do not divide is refused."""
    records = _packed(voc[3], voc[2])
    jc, pc = cfg_pair(*OPTS, "SOLVER.IMS_PER_BATCH", 4)
    mapper = pdata.DatasetMapper(pc, is_train=True)
    whole = iter(pdata.TrainLoader(records, mapper, 4, seed=3, prefetch=0,
                                   process_count=1))
    ranks = [iter(pdata.TrainLoader(records, mapper, 4, seed=3, prefetch=0,
                                    process_index=r, process_count=2))
             for r in range(2)]
    for _ in range(3):
        want = next(whole)
        got = [next(it) for it in ranks]
        assert all(g.image.shape[0] == 2 for g in got)
        assert sorted(torch.cat([g.image_id for g in got]).tolist()) == \
            sorted(want.image_id.tolist())
    with pytest.raises(ValueError, match="not divisible"):
        pdata.TrainLoader(records, mapper, 3, process_count=2)
    for r in range(2):
        ev = pdata.EvalLoader(records, None, process_index=r,
                              process_count=2)
        assert ev._records == records[r::2] and ev.all_records is records
