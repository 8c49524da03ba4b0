"""The port's predictors and demo against the JAX package's, on the CPU:
``DefaultPredictor`` on one image and its proposals from the same weights
(one Detectron2 ``.pkl``, the toy flagship config: R18, DAN [64, 64],
P = 64, float32), with the tolerance of ``tests/test_torch_slice.py``
(rtol 1e-4, atol 1e-5 times the largest value; classes and boxes equal
where a score stands apart); ``AsyncPredictor`` returning results in the
order put; the demo's ``grid_proposals`` and ``frame_proposals`` (the
latter also on a pickle whose root is not a dict, where the JAX package's
raises); and the demo CLI's printed lines on a PNG the test writes."""

import importlib.util
import pickle
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import drn_wsod_torch
from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES
from drn_wsod_torch.tools import demo as pdemo
from drn_wsod_tpu.engine.defaults import DefaultPredictor as JaxPredictor
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (FLAGSHIP, TOY, assert_detections_match,
                               cfg_pair, d2_state_dict, jax_batch,
                               param_shapes, random_params)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
TOPK = 4
OPTS = (*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
        "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 90,
        "INPUT.BUCKETS", [96], "TEST.DETECTIONS_PER_IMAGE", TOPK)


def _jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_demo", Path(__file__).resolve().parents[1] / "demo" / "demo.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    jc, _ = cfg_pair(*OPTS)
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    init = drn_wsod_torch.synthetic_batch(1, 64, 64, 64, 20, seed=3,
                                          device="cpu")
    flat = random_params(param_shapes(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(init), train=False)),
        seed=8)
    path = tmp_path_factory.mktemp("predictor") / "model.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": d2_state_dict(
            drn_wsod_torch.params_from_jax(flat))}, f)
    return str(path)


def _image_and_proposals(seed, h=45, w=61, n=80):
    rs = np.random.RandomState(seed)
    base = rs.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
    image = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))
    x1 = rs.uniform(0, w - 10, n)
    y1 = rs.uniform(0, h - 10, n)
    boxes = np.stack([x1, y1, x1 + rs.uniform(6, w, n),
                      y1 + rs.uniform(6, h, n)], 1).astype(np.float32)
    return image, boxes, np.sort(rs.uniform(-1, 1, n))[::-1].astype(
        np.float32)


def _predictors(weights):
    jc, pc = cfg_pair(*OPTS, "MODEL.WEIGHTS", weights)
    return JaxPredictor(jc), drn_wsod_torch.DefaultPredictor(pc, device="cpu")


def test_default_predictor_matches_jax(weights):
    jp, pp = _predictors(weights)
    for seed in (0, 1):
        image, boxes, obj = _image_and_proposals(seed)
        got = pp(image, boxes, obj)
        want = jp(image, boxes, obj)
        assert got.keys() == {"boxes", "scores", "classes"}
        assert len(got["scores"]) == len(want["scores"]) == TOPK
        for d in (got, want):
            d["valid"] = np.ones(len(d["scores"]), bool)
        assert_detections_match(got, {k: np.asarray(v)
                                      for k, v in want.items()},
                                RTOL, ATOL, 2)
        h, w = image.shape[:2]
        b = got["boxes"]
        assert (b >= 0).all() and (b[:, [0, 2]] <= w).all() and \
            (b[:, [1, 3]] <= h).all()
    # no objectness: zeros, as the JAX package's
    got = pp(image, boxes)
    want = jp(image, boxes)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=RTOL,
                               atol=ATOL * np.abs(want["scores"]).max())


def test_async_predictor_keeps_order(weights):
    _, pc = cfg_pair(*OPTS, "MODEL.WEIGHTS", weights)
    sync = drn_wsod_torch.DefaultPredictor(pc, device="cpu")
    pred = drn_wsod_torch.AsyncPredictor(pc, model=sync.model, device="cpu")
    inputs = [_image_and_proposals(s, h=30 + 7 * s, w=70 - 5 * s)
              for s in range(5)]
    for args in inputs:
        pred.put(*args)
    for args in inputs:
        got, want = pred.get(), sync(*args)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    pred.put(np.zeros((20, 20, 3), np.uint8), np.zeros(3, np.float32))
    with pytest.raises(Exception):
        pred.get()
    got = pred(*inputs[0])
    np.testing.assert_array_equal(got["scores"], sync(*inputs[0])["scores"])
    pred.shutdown()


def test_predictor_refuses_missing_cuda(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pc = cfg_pair(*OPTS)
    with pytest.raises(RuntimeError, match="CUDA"):
        drn_wsod_torch.DefaultPredictor(pc)


def test_grid_and_frame_proposals_equal():
    jd = _jax_demo()
    for hw in ((45, 61), (200, 120), (20, 20), (10, 10)):
        np.testing.assert_array_equal(
            pdemo.grid_proposals(*hw).reshape(-1, 4),
            np.asarray(jd.grid_proposals(*hw)).reshape(-1, 4))
    rs = np.random.RandomState(3)
    per_image = [rs.rand(5, 4).astype(np.float32) for _ in range(3)]
    scores = [rs.rand(5).astype(np.float32) for _ in range(3)]
    layouts = [{"boxes": per_image, "objectness_logits": scores},
               {"boxes": per_image, "scores": scores},
               {"boxes": per_image[0], "scores": scores[0]},
               {"boxes": per_image}]
    for data in layouts:
        for fi in range(4):
            for g, w in zip(pdemo.frame_proposals(data, fi),
                            jd.frame_proposals(data, fi)):
                np.testing.assert_array_equal(g, w)
    # a root that is no dict: one image's boxes, or a list of them
    for root, fi, want in ((per_image[1], 2, per_image[1]),
                           (per_image, 1, per_image[1]),
                           (per_image, 7, per_image[2])):
        boxes, obj = pdemo.frame_proposals(root, fi)
        np.testing.assert_array_equal(boxes, want)
        np.testing.assert_array_equal(obj, np.zeros(len(want), np.float32))
        with pytest.raises((AttributeError, ValueError)):
            jd.frame_proposals(root, fi)


def test_demo_cli_prints_detections(weights, tmp_path, capsys):
    image, boxes, obj = _image_and_proposals(4)
    Image.fromarray(image).save(tmp_path / "im.png")
    with open(tmp_path / "props.pkl", "wb") as f:
        pickle.dump({"boxes": [boxes], "objectness_logits": [obj]}, f)
    opts = [str(v) if isinstance(v, str) else repr(v) for v in OPTS]
    argv = ["--config-file", FLAGSHIP, "--input", str(tmp_path / "im.png"),
            str(tmp_path / "im.png"), "--proposals",
            str(tmp_path / "props.pkl"), "--confidence-threshold", "0.0",
            *opts, "MODEL.WEIGHTS", weights]
    n = pdemo.main(argv, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert n == 2 * TOPK and len(lines) == 2 * (TOPK + 1)
    assert lines[TOPK] == f"{tmp_path / 'im.png'}: {TOPK} detections above 0.0"
    _, pc = cfg_pair(*OPTS, "MODEL.WEIGHTS", weights)
    want = drn_wsod_torch.DefaultPredictor(pc, device="cpu")(
        np.ascontiguousarray(image[:, :, ::-1]), boxes, obj)
    for line, b, s, c in zip(lines, want["boxes"], want["scores"],
                             want["classes"]):
        assert line == (f"{VOC_CLASS_NAMES[int(c)]:>14s}  {s:.3f}  "
                        f"[{b[0]:.0f}, {b[1]:.0f}, {b[2]:.0f}, {b[3]:.0f}]")
    # --output: a sequence into a directory through the VideoVisualizer,
    # one input into a file (JPEG by its name), no other extension
    from drn_wsod_torch.data.png import read_png
    from drn_wsod_torch.native import jpeg_decode, jpeg_encode
    from drn_wsod_torch.utils.video_visualizer import VideoVisualizer
    from drn_wsod_torch.utils.visualizer import Visualizer

    pdemo.main(["--output", str(tmp_path / "out"), *argv], device="cpu")
    bgr = np.ascontiguousarray(image[:, :, ::-1])
    video = VideoVisualizer(VOC_CLASS_NAMES)
    for _ in range(2):
        frame = video.draw_frame(bgr, want["boxes"], want["scores"],
                                 want["classes"], score_thresh=0.0)
    assert np.array_equal(read_png(str(tmp_path / "out" / "im.png")), frame)
    argv_one = [a for i, a in enumerate(argv) if i != 4]   # one input
    pdemo.main(["--output", str(tmp_path / "one.jpg"), *argv_one],
               device="cpu")
    one = Visualizer(bgr, VOC_CLASS_NAMES).draw_instance_predictions(
        want["boxes"], want["scores"], want["classes"]).get_image()
    data = (tmp_path / "one.jpg").read_bytes()
    assert data == jpeg_encode(one) and jpeg_decode(data) is not None
    with pytest.raises(ValueError, match="one.bmp"):
        pdemo.main(["--output", str(tmp_path / "one.bmp"), *argv_one],
                   device="cpu")
