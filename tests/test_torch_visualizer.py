"""The port's visualizers and image writers against the JAX package's
``Visualizer`` / ``VideoVisualizer`` (Pillow's ``ImageDraw``) and Pillow's
``save``, on the CPU, with Pillow blocked in the port's calls.

Contract (``drn_wsod_torch/utils/visualizer.py``): every drawing equals
the JAX visualizer's bit for bit where each label's origin is integral.
Pillow renders a label with a fractional origin at that sub-pixel offset
and the port at the truncated origin: with the JAX side's labels drawn at
the truncated origin (``ImageDraw.text`` patched to truncate), the
drawings are bit-equal whatever the origins; and Pillow's own
fractional-origin labels differ from its truncated ones only inside the
label's text box grown by one pixel, at most ``FRACTIONAL_BOUND`` pixels
a label (the most measured here over the VOC and COCO class names is
below it).

Writers: the PNG writer round-trips exactly through ``data/png.py`` and
Pillow; the JPEG encoder's bytes equal Pillow's default ``save``
(quality 75, 4:2:0) on hypothesis-drawn images of 1-70 pixels a side.
"""

import io
import sys
from contextlib import contextmanager

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image, ImageDraw

from drn_wsod_torch.data.datasets.voc import VOC_CLASS_NAMES
from drn_wsod_torch.data.png import decode_png, encode_png
from drn_wsod_torch.native import jpeg_decode, jpeg_encode
from drn_wsod_torch.tools import make_font_fixtures
from drn_wsod_torch.utils import video_visualizer as pvv
from drn_wsod_torch.utils import visualizer as pv
from drn_wsod_tpu.utils import video_visualizer as jvv
from drn_wsod_tpu.utils import visualizer as jv

COCO_NAMES = (
    "person bicycle car motorcycle airplane bus train truck boat "
    "traffic_light fire_hydrant stop_sign parking_meter bench bird cat dog "
    "horse sheep cow elephant bear zebra giraffe backpack umbrella handbag "
    "tie suitcase frisbee skis snowboard sports_ball kite baseball_bat "
    "baseball_glove skateboard surfboard tennis_racket bottle wine_glass "
    "cup fork knife spoon bowl banana apple sandwich orange broccoli "
    "carrot hot_dog pizza donut cake chair couch potted_plant bed "
    "dining_table toilet tv laptop mouse remote keyboard cell_phone "
    "microwave oven toaster sink refrigerator book clock vase scissors "
    "teddy_bear hair_drier toothbrush").replace("_", "~").split()
COCO_NAMES = [n.replace("~", " ") for n in COCO_NAMES]
FRACTIONAL_BOUND = 560   # 520 measured, the longest COCO labels


@contextmanager
def no_pillow():
    """Pillow unimportable for the port's calls."""
    saved = {k: sys.modules[k] for k in list(sys.modules)
             if k == "PIL" or k.startswith("PIL.")}
    for k in saved:
        del sys.modules[k]
    sys.modules["PIL"] = None
    try:
        yield
    finally:
        del sys.modules["PIL"]
        sys.modules.update(saved)


@contextmanager
def truncated_text():
    """The JAX side's labels drawn at the truncated origin."""
    text = ImageDraw.ImageDraw.text

    def patched(self, xy, *a, **k):
        return text(self, (int(xy[0]), int(xy[1])), *a, **k)
    ImageDraw.ImageDraw.text = patched
    try:
        yield
    finally:
        ImageDraw.ImageDraw.text = text


def _image(seed, h=120, w=160):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)) \
        .astype(np.uint8)


def _both(factory, seed=0, names=VOC_CLASS_NAMES, truncate=False):
    """factory(rng)(visualizer) on the JAX and the port's visualizer of
    one BGR image, each with its own rng of ``seed``: (JAX RGB, port
    RGB)."""
    img = _image(seed)
    fn = factory(np.random.RandomState(seed))
    if truncate:
        with truncated_text():
            want = fn(jv.Visualizer(img, names)).get_image()
    else:
        want = fn(jv.Visualizer(img, names)).get_image()
    fn = factory(np.random.RandomState(seed))
    with no_pillow():
        got = fn(pv.Visualizer(img, names)).get_image()
    return np.asarray(want), got


def test_font_table_is_fresh():
    assert make_font_fixtures.build_table() == \
        __import__("json").loads(make_font_fixtures.TABLE.read_text())


@pytest.mark.parametrize("names", [VOC_CLASS_NAMES, COCO_NAMES],
                         ids=["voc", "coco"])
def test_labels_at_integral_origins_bit_equal(names):
    rng = np.random.RandomState(1)
    labels = [f"{n} {s:.2f}" for n in names
              for s in rng.uniform(0, 1, 2)] + list(names) + \
        ["".join(chr(c) for c in range(32, 127))]
    for i, label in enumerate(labels):
        img = _image(i, 40, 620)
        xy = (int(rng.randint(-20, 40)), int(rng.randint(-8, 30)))
        color = tuple(int(v) for v in rng.randint(0, 256, 3))
        pil = Image.fromarray(img)
        ImageDraw.Draw(pil).text(xy, label, fill=color)
        canvas = pv.Canvas(img.copy())
        canvas.text(xy, label, color)
        assert np.array_equal(canvas.img, np.asarray(pil)), label


def test_fractional_labels_differ_only_inside_their_box():
    """Pillow's sub-pixel label against Pillow's truncated one: the
    pixels that differ lie in the truncated label's box grown by 1."""
    rng = np.random.RandomState(2)
    worst = 0
    for i, name in enumerate(list(VOC_CLASS_NAMES) + COCO_NAMES):
        label = f"{name} {rng.uniform():.2f}"
        xy = (float(rng.uniform(0, 40)), float(rng.uniform(0, 20)))
        img = _image(i, 40, 400)
        frac, trunc = Image.fromarray(img), Image.fromarray(img)
        ImageDraw.Draw(frac).text(xy, label, fill=(250, 20, 90))
        ImageDraw.Draw(trunc).text((int(xy[0]), int(xy[1])), label,
                                   fill=(250, 20, 90))
        diff = np.any(np.asarray(frac) != np.asarray(trunc), -1)
        mask, left, top = pv.render_text(label)
        x0, y0 = int(xy[0]) + left - 1, int(xy[1]) + top - 1
        box = np.zeros_like(diff)
        box[max(y0, 0):y0 + mask.shape[0] + 2,
            max(x0, 0):x0 + mask.shape[1] + 2] = True
        assert not (diff & ~box).any(), label
        worst = max(worst, int(diff.sum()))
    assert 0 < worst <= FRACTIONAL_BOUND, worst


def _dets(rng, n=6, h=120, w=160):
    xy = rng.uniform(-10, [w, h], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 60, (n, 2))], 1)
    return (boxes.astype(np.float32), rng.uniform(0, 1, n).astype(np.float32),
            rng.randint(0, 20, n), rng.rand(n) > 0.2)


METHODS = {
    "instances": lambda rng: lambda v: v.draw_instance_predictions(
        *_dets(rng), score_thresh=0.2,
        masks=rng.rand(6, 120, 160) > 0.7,
        keypoints=np.concatenate([rng.uniform(-5, 165, (6, 17, 2)),
                                  rng.randint(0, 3, (6, 17, 1))], -1)),
    "box_unlabeled": lambda rng: lambda v: v.draw_box(
        rng.uniform(0, 80, 4).cumsum()[[0, 1, 2, 3]] * [1, 1, 1, 1],
        class_id=None),
    "box_out_of_table": lambda rng: lambda v: v.draw_box(
        [3.5, 2.25, 90.75, 60.5], class_id=33, score=0.5),
    "mask": lambda rng: lambda v: v.draw_mask(rng.rand(120, 160) > 0.5, 3),
    "keypoints": lambda rng: lambda v: v.draw_keypoints(
        np.concatenate([rng.uniform(0, 160, (5, 2)),
                        rng.randint(0, 2, (5, 1))], -1), 2,
        skeleton=[(0, 1), (1, 2), (3, 4), (2, 4)]),
    "rotated": lambda rng: lambda v: v.draw_rotated_box(
        [80.3, 60.7, 50.2, 30.9, float(rng.uniform(-90, 90))], 4, 0.61),
    "panoptic": lambda rng: lambda v: v.draw_panoptic_seg(
        rng.randint(0, 5, (120, 160)),
        [{"id": i, "category_id": 3 * i, "isthing": i % 2 == 0}
         for i in range(1, 5)]),
    "dataset_dict": lambda rng: lambda v: v.draw_dataset_dict({
        "annotations": [
            {"category_id": 1, "bbox": [10.5, 12.25, 40, 30]},
            {"category_id": 2, "bbox": [5, 6, 70.5, 80.5], "bbox_mode": 0,
             "segmentation": [[5, 6, 70.5, 8, 60, 80.5, 9.9, 70]],
             "keypoints": list(rng.uniform(0, 100, 51))}],
        "sem_seg": rng.randint(0, 4, (120, 160))}),
    "sem_seg": lambda rng: lambda v: v.draw_sem_seg(
        np.where(rng.rand(120, 160) > 0.9, 255, rng.randint(0, 6, (120, 160)))),
    "boxes_integral": lambda rng: lambda v: [v.draw_box(
        [x, y, x + 30, y + 20], c, round(s, 2)) for x, y, c, s in zip(
            rng.randint(0, 100, 5), rng.randint(11, 90, 5),
            rng.randint(0, 20, 5), rng.uniform(0, 1, 5))][-1],
}


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("seed", [0, 1])
def test_methods_equal_jax_with_truncated_labels(method, seed):
    want, got = _both(METHODS[method], seed, truncate=True)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("method", ["boxes_integral", "mask", "sem_seg",
                                    "box_unlabeled"])
def test_methods_with_integral_labels_bit_equal(method):
    """No fractional label, so no patch: bit-equal to the JAX package."""
    want, got = _both(METHODS[method])
    assert np.array_equal(got, want)


def test_video_visualizer_tracks_colours_as_jax():
    rng = np.random.RandomState(3)
    frames = [_image(i) for i in range(4)]
    boxes = rng.uniform(0, 80, (5, 2))
    boxes = np.concatenate([boxes, boxes + 30], 1).astype(np.float32)
    jvis, pvis = jvv.VideoVisualizer(VOC_CLASS_NAMES), \
        pvv.VideoVisualizer(VOC_CLASS_NAMES)
    for f in frames:
        boxes = boxes + rng.uniform(-3, 3, boxes.shape).astype(np.float32)
        scores = rng.uniform(0, 1, 5)
        classes = rng.randint(0, 3, 5)
        with truncated_text():
            want = jvis.draw_frame(f, boxes, scores, classes, 0.1)
        with no_pillow():
            got = pvis.draw_frame(f, boxes, scores, classes, 0.1)
        assert np.array_equal(got, np.asarray(want))
    assert [t.color for t in pvis._tracks] == [t.color for t in jvis._tracks]


def test_save_pgt_visualization_and_formats(tmp_path):
    img = _image(5)
    boxes = np.array([[10, 12, 50, 60], [0, 0, 0, 0], [20, 30, 90, 99]],
                     np.float32)
    valid = np.array([True, False, True])
    jv.save_pgt_visualization(img, boxes, valid, VOC_CLASS_NAMES,
                              str(tmp_path / "jax"), "it", "_a")
    with no_pillow():
        pv.save_pgt_visualization(img, boxes, valid, VOC_CLASS_NAMES,
                                  str(tmp_path / "port"), "it", "_a")
        got = decode_png((tmp_path / "port" / "it_a.png").read_bytes())
        v = pv.Visualizer(img, VOC_CLASS_NAMES).draw_box(boxes[0], 1, 0.5)
        v.save(str(tmp_path / "port" / "x.jpg"))
        with pytest.raises(ValueError, match="x.gif"):
            v.save(str(tmp_path / "port" / "x.gif"))
    want = np.asarray(Image.open(tmp_path / "jax" / "it_a.png"))
    assert np.array_equal(got, want)
    v.save(str(tmp_path / "port" / "y.png"))
    Image.fromarray(v.get_image()).save(tmp_path / "jax" / "x.jpg")
    assert (tmp_path / "port" / "x.jpg").read_bytes() == \
        (tmp_path / "jax" / "x.jpg").read_bytes()


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 70),
       kind=st.sampled_from(["noise", "flat", "ramp"]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_jpeg_bytes_equal_pillow(h, w, kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "noise":
        a = rng.randint(0, 256, (h, w, 3))
    elif kind == "flat":
        a = np.broadcast_to(rng.randint(0, 256, 3), (h, w, 3))
    else:
        yy, xx = np.mgrid[:h, :w]
        a = np.stack([xx * rng.randint(1, 9), yy * rng.randint(1, 9),
                      xx + yy], -1) % 256
    a = np.ascontiguousarray(a, np.uint8)
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG")
    with no_pillow():
        got = jpeg_encode(a)
        assert jpeg_decode(got) is not None
    assert got == buf.getvalue()


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       c=st.sampled_from([1, 3, 4]), seed=st.integers(0, 2 ** 31 - 1))
def test_png_round_trips(h, w, c, seed):
    a = np.random.RandomState(seed).randint(0, 256, (h, w, c)) \
        .astype(np.uint8)
    if c == 1:
        a = a[..., 0]
    with no_pillow():
        data = encode_png(a)
        assert np.array_equal(decode_png(data), a)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), a)


def test_writers_refuse_other_inputs():
    with pytest.raises(ValueError):
        jpeg_encode(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4, 3), np.float32))
