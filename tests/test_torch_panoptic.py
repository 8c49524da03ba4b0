"""PanopticFPN, the COCO panoptic loader and PQ against the JAX package,
on the CPU:

  * ``load_coco_panoptic_separated`` on the PNG fixtures' tree: records
    and metadata equal;
  * ``combine_semantic_and_instance_outputs`` and
    ``PanopticQualityEvaluator`` exact (overlapping instances, low scores,
    small stuff, GT void, a prediction mostly on void);
  * the mask targets of the shared channel pool (``meta_arch.
    mask_targets``) bit-equal to the JAX model's per-slot crop of the
    matched mask;
  * the toy PanopticFPN (R18-FPN 32, 20 thing and 5 stuff classes, box
    pool 4 x 4, mask pool 4 x 4 in both models, float32) on the batches of
    ``tests/test_torch_mask_rcnn.py`` with label maps: its four losses
    within rtol 1e-5 and 3 train steps against JAX ``make_train_step``
    within rtol 1e-4 (13 valid proposals fill the 16 slots whatever the
    sampler's keys), ``inference_scores`` and the boxes of the live slots,
    ``predict_masks`` against JAX's ``mask_probs``;
  * ``panoptic_inference_on_dataset`` exact against JAX's on the same
    detections and maps, over the fixtures' val split;
  * copied, not fixed: the panoptic YAML names no proposal file while
    ``MODEL.LOAD_PROPOSALS`` is on, so the mapper gives every image 0
    live proposals and the instance branch trains on no slot (its losses
    0) in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch import data as pdata
from drn_wsod_torch.data.datasets.coco import load_coco_panoptic_separated
from drn_wsod_torch.evaluation import (PanopticQualityEvaluator,
                                       combine_semantic_and_instance_outputs,
                                       panoptic_inference_on_dataset)
from drn_wsod_torch.models.meta_arch import mask_targets
from drn_wsod_torch.tools import make_png_fixtures as fx
from drn_wsod_tpu import data as jdata
from drn_wsod_tpu.data.datasets import coco as jcoco
from drn_wsod_tpu.evaluation import evaluator as jev
from drn_wsod_tpu.evaluation import panoptic_eval as jpan
from drn_wsod_tpu.models import build_model as jax_build_model
from drn_wsod_tpu.ops.roi_align import roi_align as jax_roi_align
from test_torch_common import (CONFIGS, cfg_pair, flatten, jax_batch,
                               param_shapes, random_params, unflatten)
from test_torch_mask_rcnn import _dense_batch
from test_torch_train_slice import _jax_steps, _port_steps

torch.set_num_threads(1)

PAN_YAML = str(CONFIGS / "Misc" / "panoptic_fpn_R_50_1x.yaml")
S = 5
TOY = ("MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
       "MODEL.FPN.OUT_CHANNELS", 32, "MODEL.ROI_HEADS.NUM_CLASSES", 20,
       "MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION", 4,
       "MODEL.SEM_SEG_HEAD.NUM_CLASSES", S, "MODEL.SEM_SEG_HEAD.CONVS_DIM", 16,
       "MODEL.DTYPE", "float32", "MODEL.PIXEL_STD", [57.4, 57.1, 58.4])
ROOT = fx.FIXTURE_DIR / "panoptic"


def tree_args(split: str):
    return (str(ROOT / "annotations" / f"panoptic_{split}.json"), str(ROOT),
            str(ROOT / f"panoptic_{split}"),
            str(ROOT / f"panoptic_stuff_{split}"),
            str(ROOT / "annotations" / f"instances_{split}.json"))


def pan_batch(seed: int):
    """``_dense_batch(seed)`` with a (2, 64, 64) label map of S classes."""
    b = _dense_batch(seed)
    rs = np.random.RandomState(70 + seed)
    sem = rs.randint(0, S, b.image.shape[:3]).astype(np.int32)
    sem[:, :2] = 255
    return b.replace(sem_seg=torch.from_numpy(sem))


@pytest.fixture(scope="module")
def models():
    jc, pc = cfg_pair(*TOY, yaml=PAN_YAML)
    jm = jax_build_model(jc).clone(mask_pooler_resolution=4)
    key = jax.random.PRNGKey(0)
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(pan_batch(0)),
        train=True)), seed=1)

    def port():
        pm = drn_wsod_torch.build_model(pc, device="cpu")
        pm.mask_pooler_resolution = 4
        pm.load_state_dict(drn_wsod_torch.params_from_jax(flat), strict=True)
        return pm
    return jm, flat, port, jc, pc


@pytest.mark.parametrize("split", ["train2017", "val2017"])
def test_loader_equals_jax(split):
    got = load_coco_panoptic_separated(*tree_args(split), "torch_pan_ds")
    want = jcoco.load_coco_panoptic_separated(*tree_args(split),
                                              "torch_pan_ds")
    assert got == want
    assert all(r["segments_info"] for r in got)
    for key in ("stuff_classes", "stuff_dataset_id_to_contiguous_id",
                "thing_classes"):
        assert pdata.MetadataCatalog.get("torch_pan_ds").get(key) == \
            jdata.MetadataCatalog.get("torch_pan_ds").get(key)
    assert len(pdata.MetadataCatalog.get("torch_pan_ds").stuff_classes) == 54


def _instances(rs, n, h, w):
    masks = np.zeros((n, h, w), bool)
    for k in range(n):
        y, x = rs.randint(0, h - 4), rs.randint(0, w - 4)
        masks[k, y:y + rs.randint(3, h // 2), x:x + rs.randint(3, w // 2)] = 1
    return masks, rs.uniform(0.2, 1.0, n), rs.randint(0, 4, n)


@pytest.mark.parametrize("seed", range(4))
def test_combine_exact(seed):
    rs = np.random.RandomState(seed)
    h, w = 40, 52
    masks, scores, classes = _instances(rs, 9, h, w)
    sem = rs.randint(0, 4, (h // 8 + 1, w // 8 + 1))
    sem = np.kron(sem, np.ones((8, 8), int))[:h, :w]
    for kw in ({}, {"overlap_threshold": 0.3, "stuff_area_limit": 40,
                    "instances_confidence_threshold": 0.4}):
        got = combine_semantic_and_instance_outputs(masks, scores, classes,
                                                    sem, **kw)
        want = jpan.combine_semantic_and_instance_outputs(
            masks, scores, classes, sem, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_pq_exact():
    rs = np.random.RandomState(3)
    pe, je = PanopticQualityEvaluator(7), jpan.PanopticQualityEvaluator(7)
    for _ in range(4):
        gt = rs.randint(0, 6, (30, 40))
        pred = np.where(rs.rand(30, 40) < 0.8, gt, rs.randint(0, 7, (30, 40)))
        pred[:5, :10] = 6                  # a prediction mostly on void
        gt[:6, :12] = 0
        gi = [{"id": i, "category_id": int(rs.randint(7))}
              for i in range(1, 6)]
        pi = [{"id": i, "category_id": g["category_id"] if i < 4
               else int(rs.randint(7))} for i, g in zip(range(1, 7), gi + gi)]
        pe.process_single(pred, pi, gt, gi)
        je.process_single(pred, pi, gt, gi)
    got, want = pe.evaluate(), je.evaluate()
    np.testing.assert_equal(got, want)
    assert 0 < got["panoptic_seg"]["PQ"] < 100
    np.testing.assert_equal(pe.state_dict(), je.state_dict())


def test_mask_targets_equal_per_slot_crop():
    """The channel pool against the JAX model's crop of each slot's
    matched mask (``panoptic.py``'s ``crop_one``)."""
    b = _dense_batch(1)
    rs = np.random.RandomState(5)
    boxes = b.proposals.numpy()[:, :13].copy()
    boxes += rs.uniform(-2, 2, boxes.shape).astype(np.float32)
    midx = rs.randint(0, 3, boxes.shape[:2])
    for m in (8, 28):
        got = mask_targets(b.gt_masks, torch.from_numpy(boxes),
                           torch.from_numpy(midx), m).numpy()
        masks = b.gt_masks.numpy().astype(np.float32)
        want = np.stack([[np.asarray(jax_roi_align(
            masks[i, g][..., None], bx[None], 1.0, resolution=m,
            sampling_ratio=2, aligned=True))[0, ..., 0]
            for g, bx in zip(midx[i], boxes[i])] for i in range(2)])
        np.testing.assert_array_equal(got, (want >= 0.5).astype(np.float32))
        assert 0 < got.mean() < 1


def test_losses_and_steps(models):
    jm, flat, port, jc, pc = models
    pm = port()
    b = pan_batch(0)
    want = jm.apply({"params": unflatten(flat)}, jax_batch(b), train=True,
                    rngs={"dropout": jax.random.PRNGKey(2)})
    got = pm(b, train=True, generator=torch.Generator().manual_seed(0))
    assert set(got) == set(want) == {"loss_sem_seg", "loss_cls",
                                     "loss_box_reg", "loss_mask"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)
    batches = [pan_batch(s) for s in range(3)]
    jax_state, jax_metrics = _jax_steps(jm, flat, jc, batches)
    port_state, port_metrics = _port_steps(pm, pc, batches)
    for w, g in zip(jax_metrics, port_metrics):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    want = drn_wsod_torch.params_from_jax(
        {k: np.asarray(v) for k, v in flatten(
            jax_state.params["params"]).items()})
    sd = port_state.model.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].float().numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_inference(models):
    jm, flat, port, _, _ = models
    pm = port()
    b = pan_batch(4)
    v = {"params": unflatten(flat)}
    js, jb = jm.apply(v, jax_batch(b), method="inference_scores")
    ps, pb = pm.inference_scores(b)
    live = b.proposal_mask.numpy()
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(pb.numpy()[live], np.asarray(jb)[live],
                               rtol=1e-5, atol=1e-4)
    dets = torch.tensor([[[4.0, 4.0, 30.0, 30.0], [10, 20, 50, 60]]] * 2)
    cls = torch.tensor([[0, 7]] * 2)
    want = np.asarray(jm.apply(v, jax_batch(b), jnp.asarray(dets.numpy()),
                               jnp.asarray(cls.numpy()), method="mask_probs"))
    got = pm.predict_masks(pm.features(b.image), dets, cls)
    assert got.shape == (2, 2, 8, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    want = np.asarray(jm.apply(v, jax_batch(b), method="semantic_logits"))
    np.testing.assert_allclose(pm.semantic_logits(b).numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def test_panoptic_loop_exact():
    """Both loops on the fixtures' val split, the same detections (two
    boxes an image with their masks, scores above and below the
    confidence threshold) and the same semantic maps."""
    records = load_coco_panoptic_separated(*tree_args("val2017"))
    for r in records:
        r["image"] = np.zeros((r["height"], r["width"], 3), np.uint8)
    jc, pc = cfg_pair(*TOY, "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST",
                      96, "INPUT.BUCKETS", [96], "MODEL.LOAD_PROPOSALS",
                      False, "MODEL.ROI_HEADS.NUM_CLASSES", 80,
                      yaml=PAN_YAML)
    rs = np.random.RandomState(9)
    dets = {r["image_id"]: {
        "boxes": np.array([[5, 5, 60, 40], [20, 10, 90, 70]], np.float32),
        "scores": np.array([0.9, 0.3], np.float32),
        "classes": rs.randint(0, 80, 2),
        "valid": np.array([True, True]),
        "mask_probs": rs.uniform(0, 1, (2, 28, 28)).astype(np.float32)}
        for r in records}
    sems = {r["image_id"]: rs.randint(0, 54, (96, 96)).astype(np.int32)
            for r in records}
    sems[records[0]["image_id"]][:] = 7          # one large stuff segment

    def ids_of(batch):
        return [records[int(i)]["image_id"] for i in np.asarray(
            batch.image_id)]

    def port_detect(batch):
        return {k: torch.from_numpy(np.stack([dets[i][k]
                                              for i in ids_of(batch)]))
                for k in dets[records[0]["image_id"]]}

    def port_sem(batch):
        return torch.from_numpy(np.stack([sems[i] for i in ids_of(batch)]))

    def jax_detect(_, batch):
        return {k: np.asarray(v) for k, v in port_detect(batch).items()}

    def jax_sem(_, batch):
        return port_sem(batch).numpy()

    kw = dict(num_thing_classes=80, stuff_area_limit=64)
    got = panoptic_inference_on_dataset(
        port_detect, port_sem, pdata.EvalLoader(
            records, pdata.DatasetMapper(pc, False), prefetch=0),
        PanopticQualityEvaluator(133), records, **kw)
    want = jev.panoptic_inference_on_dataset(
        jax_detect, jax_sem, None, jdata.EvalLoader(
            records, jdata.DatasetMapper(jc, False), prefetch=0),
        jpan.PanopticQualityEvaluator(133), records, **kw)
    np.testing.assert_equal(got, want)
    assert got["panoptic_seg"]["N"] > 0


def test_no_proposal_file_no_live_slot(models):
    """The YAML as it stands: ``LOAD_PROPOSALS`` True and no proposal
    file, so the test and train mappers give 0 live slots, and the
    instance branch's losses are 0 in both packages (the sampler adds no
    GT boxes). Copied, not fixed."""
    jm, flat, port, _, _ = models
    jc, pc = cfg_pair(yaml=PAN_YAML)
    assert pc.MODEL.LOAD_PROPOSALS and not pc.DATASETS.PROPOSAL_FILES_TRAIN
    records = load_coco_panoptic_separated(*tree_args("val2017"))
    r = dict(records[0], image=np.zeros((records[0]["height"],
                                         records[0]["width"], 3), np.uint8))
    for mapper in (pdata.DatasetMapper(pc, True),
                   jdata.DatasetMapper(jc, True)):
        out = mapper(dict(r), np.random.RandomState(0))
        assert not out["proposal_mask"].any()
        assert out["gt_valid"].any()
    b = pan_batch(0)
    b = b.replace(proposal_mask=torch.zeros_like(b.proposal_mask))
    pm = port()
    got = pm(b, train=True, generator=torch.Generator().manual_seed(0))
    want = jm.apply({"params": unflatten(flat)}, jax_batch(b), train=True,
                    rngs={"dropout": jax.random.PRNGKey(2)})
    for k in ("loss_cls", "loss_box_reg", "loss_mask"):
        assert got[k].item() == float(want[k]) == 0.0
    assert got["loss_sem_seg"].item() > 0
