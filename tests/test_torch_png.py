"""The port's PNG reader (``data/png.py``) against Pillow, on the CPU:

  * under hypothesis: every mode and depth (gray 1/2/4/8/16 bits,
    palette 1/2/4/8 bits with a short palette and tRNS, gray+alpha, RGB,
    RGBA at 8 and 16 bits), plain or interlaced (Adam7), sizes 1-97, each
    row's filter drawn from the five types, the IDAT stream in 1-4 chunks
    (``tools/make_png_fixtures.py:encode_png``) and Pillow's own files:
    ``decode_png`` equal to ``np.asarray(Image.open(f))`` (values, dtype,
    shape) and ``decode_png_rgb`` to its ``convert("RGB")``, with the C++
    unfilter and its numpy twin;
  * the committed fixtures (``drn_wsod_torch/data/png_fixtures``): equal
    to a fresh build, each file to its manifest digests, the mapper's
    ``sem_seg`` canvases to theirs;
  * interlaced and 16-bit files decode as Pillow does, with or without
    Pillow; CRC, zlib and filter-type faults raise, naming the file;
  * ``read_image`` on a PNG as the JAX package's (Pillow);
  * the label maps' nearest resize (``transforms.resize_nearest``)
    against Pillow's ``NEAREST`` under hypothesis.
"""

import io
import sys

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from drn_wsod_torch.data import png
from drn_wsod_torch.data import transforms as pT
from drn_wsod_torch.data.mapper import read_image
from drn_wsod_torch.tools import make_png_fixtures as fx
from drn_wsod_tpu.data.mapper import read_image as jax_read_image

# (colour type, depth, channels)
KINDS = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 1), (3, 1, 1),
         (3, 2, 1), (3, 4, 1), (3, 8, 1), (4, 8, 2), (4, 16, 2), (2, 8, 3),
         (2, 16, 3), (6, 8, 4), (6, 16, 4)]


def pillow(data: bytes):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im), np.asarray(im.convert("RGB"))


def assert_same(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@settings(max_examples=60, deadline=None)
@given(kind=st.sampled_from(KINDS), h=st.integers(1, 97),
       w=st.integers(1, 97), chunks=st.integers(1, 4),
       seed=st.integers(0, 2 ** 31 - 1), interlace=st.booleans(),
       data=st.data())
def test_decode_equals_pillow(kind, h, w, chunks, seed, interlace, data):
    colour, depth, ch = kind
    rng = np.random.RandomState(seed)
    filters = data.draw(st.lists(st.integers(0, 4), min_size=1, max_size=8))
    samples = rng.randint(0, 1 << depth, (h, w, ch))
    palette = trns = None
    if colour == 3:
        n = int(rng.randint(1, (1 << depth) + 1))
        palette = rng.randint(0, 256, (n, 3))
        trns = bytes(rng.randint(0, 256, rng.randint(0, n + 1))
                     .astype(np.uint8)) or None
    raw = fx.encode_png(samples, colour, depth, palette, trns, filters,
                        min(chunks, 1 + h), interlace)
    want, want_rgb = pillow(raw)
    for plain in (False, True):
        assert_same(png.decode_png(raw, plain), want)
        assert_same(png.decode_png_rgb(raw, plain), want_rgb)


@settings(max_examples=25, deadline=None)
@given(mode=st.sampled_from(["L", "P", "LA", "RGB", "RGBA"]),
       h=st.integers(1, 97), w=st.integers(1, 97),
       seed=st.integers(0, 2 ** 31 - 1), optimize=st.booleans())
def test_pillow_files(mode, h, w, seed, optimize):
    """Pillow's writer (adaptive filters: Paeth on smooth rows)."""
    rng = np.random.RandomState(seed)
    ch = {"L": 1, "P": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    a = np.cumsum(rng.randint(0, 5, (h, w, ch)), axis=1).astype(np.uint8)
    im = Image.fromarray(a[..., 0] if ch == 1 else a, mode)
    if mode == "P":
        im.putpalette(rng.randint(0, 256, 768).tolist())
    buf = io.BytesIO()
    im.save(buf, "PNG", optimize=optimize)
    want, want_rgb = pillow(buf.getvalue())
    assert_same(png.decode_png(buf.getvalue()), want)
    assert_same(png.decode_png_rgb(buf.getvalue()), want_rgb)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 8])
def test_unfilter_twins(bpp):
    rng = np.random.RandomState(bpp)
    H, stride = 23, 8 * 9
    raw = rng.randint(0, 256, (H, stride + 1)).astype(np.uint8)
    raw[:, 0] = np.arange(H) % 5
    got = png.unfilter(raw.reshape(-1), H, stride, bpp)
    np.testing.assert_array_equal(got, png.unfilter_plain(raw.reshape(-1), H,
                                                          stride, bpp))
    raw[3, 0] = 7
    for fn in (png.unfilter, png.unfilter_plain):
        with pytest.raises(ValueError, match="filter type 7"):
            fn(raw.reshape(-1), H, stride, bpp)
        with pytest.raises(ValueError, match="truncated"):
            fn(raw.reshape(-1)[:-1], H, stride, bpp)


def test_committed_fixtures_are_fresh(tmp_path):
    """A stale fixture shows: a build from the manifest's seed writes the
    same files and the same manifest."""
    committed = fx.FIXTURE_DIR
    want = fx.load_manifest()
    got = fx.build(want["seed"], out=tmp_path)
    assert got == want
    files = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(committed)
                           for p in committed.rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / rel).read_bytes() == (committed / rel).read_bytes()


def test_fixtures_decode_to_their_digests():
    """Every committed file, interlaced and 16-bit ones included, to the
    digests of Pillow's decode."""
    manifest = fx.load_manifest()
    modes = {e["mode"] for e in manifest["files"].values()}
    assert {"1", "L", "P", "LA", "RGB", "RGBA", "I;16"} <= modes
    names = {rel.split("/")[-1] for rel in manifest["files"]}
    for name, colour, depth, ch in fx.WIDE:
        assert f"adam7_{name}.png" in names
        if depth == 16:
            assert f"{name}.png" in names
    for rel, e in manifest["files"].items():
        data = (fx.FIXTURE_DIR / rel).read_bytes()
        for plain in (False, True):
            a = png.decode_png(data, plain)
            assert (str(a.dtype), list(a.shape)) == (e["dtype"], e["shape"])
            assert fx.digest(a) == e["sha256"], rel
            assert fx.digest(png.decode_png_rgb(data, plain)) == \
                e["rgb_sha256"], rel


def test_mapper_canvases_to_their_digests():
    """The semantic YAML's training mapper on the tree's train records,
    each with its manifest seed: the ``sem_seg`` canvas (resize by the
    port's nearest, flip) equal to the digest of Pillow's."""
    from drn_wsod_torch.data import DatasetMapper
    from drn_wsod_torch.data.datasets.coco import \
        load_coco_panoptic_separated

    manifest = fx.load_manifest()
    root = fx.FIXTURE_DIR / "panoptic"
    records = load_coco_panoptic_separated(
        str(root / "annotations" / "panoptic_train2017.json"), str(root),
        str(root / "panoptic_train2017"),
        str(root / "panoptic_stuff_train2017"),
        str(root / "annotations" / "instances_train2017.json"))
    mapper = DatasetMapper(fx.sem_mapper_cfg(), is_train=True)
    assert len(records) == len(manifest["mapper"]) == 8
    for r, e in zip(records, manifest["mapper"]):
        assert r["image_id"] == e["image_id"]
        r = dict(r, image=np.zeros((r["height"], r["width"], 3), np.uint8))
        out = mapper(r, np.random.RandomState(e["seed"]))
        assert out["_bucket"] == e["bucket"]
        assert fx.digest(out["sem_seg"]) == e["sha256"]
    assert len({e["bucket"] for e in manifest["mapper"]}) > 1


@pytest.fixture
def no_pillow(monkeypatch):
    for k in ("PIL", "PIL.Image"):
        monkeypatch.setitem(sys.modules, k, None)


@pytest.mark.parametrize("name,feature", [
    ("interlaced_rgb8.png", "interlaced"), ("gray16.png", "16-bit")])
def test_fallback_to_pillow(name, feature):
    """The files the reader once left to Pillow: its own decode now,
    equal to Pillow's (which is present here)."""
    path = str(fx.FIXTURE_DIR / "modes" / name)
    with Image.open(path) as im:
        want, want_rgb = np.asarray(im), np.asarray(im.convert("RGB"))
    assert_same(png.read_png(path), want)
    assert_same(png.read_png_rgb(path), want_rgb)


@pytest.mark.parametrize("name,feature", [
    ("interlaced_rgb8.png", "interlaced"), ("gray16.png", "16-bit")])
def test_without_pillow_names_file_and_feature(name, feature, no_pillow,
                                              tmp_path):
    """Without Pillow the interlaced and 16-bit files decode to the
    digests of Pillow's decode; a file cut short still names the file."""
    e = fx.load_manifest()["files"][f"modes/{name}"]
    path = str(fx.FIXTURE_DIR / "modes" / name)
    a = png.read_png(path)
    assert (str(a.dtype), list(a.shape)) == (e["dtype"], e["shape"])
    assert fx.digest(a) == e["sha256"]
    assert fx.digest(png.read_png_rgb(path)) == e["rgb_sha256"]
    cut = tmp_path / name
    cut.write_bytes((fx.FIXTURE_DIR / "modes" / name).read_bytes()[:-20])
    for fn in (png.read_png, png.read_png_rgb):
        with pytest.raises(ValueError, match=name):
            fn(str(cut))


@pytest.mark.parametrize("name", [n for n, *_ in fx.WIDE])
@pytest.mark.parametrize("interlace", [True, False],
                         ids=["adam7", "plain"])
def test_adam7_and_16bit_without_pillow(name, interlace, no_pillow):
    """Each colour type and depth, interlaced and plain:
    ``read_png`` (a label map) and ``read_png_rgb`` with Pillow blocked
    against the digests of Pillow's ``np.asarray(Image.open(f))`` and
    ``convert("RGB")``."""
    rel = f"modes/adam7_{name}.png" if interlace else f"modes/{name}.png"
    e = fx.load_manifest()["files"][rel]
    path = str(fx.FIXTURE_DIR / rel)
    a = png.read_png(path)
    assert (str(a.dtype), list(a.shape)) == (e["dtype"], e["shape"])
    assert fx.digest(a) == e["sha256"]
    assert fx.digest(png.read_png_rgb(path)) == e["rgb_sha256"]


def test_faults_raise(tmp_path):
    data = bytearray((fx.FIXTURE_DIR / "modes" / "rgb8.png").read_bytes())
    bad_crc = bytearray(data)
    bad_crc[40] ^= 0xFF                      # inside an IDAT body
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad_crc))
    body = b"not zlib at all"
    broken = fx._chunk(b"IHDR", data[16:29]) + fx._chunk(b"IDAT", body)
    with pytest.raises(ValueError, match="inflate"):
        png.decode_png(png.SIGNATURE + broken + fx._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + bytes(data[6:]))
    path = tmp_path / "cut.png"
    path.write_bytes(bytes(data[:-20]))
    with pytest.raises(ValueError, match="cut.png"):
        png.read_png(str(path))


@pytest.mark.parametrize("name", ["rgb8.png", "palette4.png", "gray2.png",
                                  "rgba8.png", "gray_alpha8.png"])
@pytest.mark.parametrize("fmt", ["BGR", "RGB"])
def test_read_image_png_as_jax(name, fmt):
    path = str(fx.FIXTURE_DIR / "modes" / name)
    got = read_image(path, fmt)
    want = jax_read_image(path, fmt)
    assert_same(got, np.asarray(want))


@settings(max_examples=80, deadline=None)
@given(h=st.integers(1, 200), w=st.integers(1, 200),
       nh=st.integers(1, 300), nw=st.integers(1, 300),
       dtype=st.sampled_from([np.uint8, np.int32]),
       seed=st.integers(0, 2 ** 31 - 1))
def test_nearest_resize_equals_pillow(h, w, nh, nw, dtype, seed):
    seg = np.random.RandomState(seed).randint(0, 250, (h, w)).astype(dtype)
    want = np.asarray(Image.fromarray(seg).resize((nw, nh), Image.NEAREST))
    got = pT.ResizeTransform(h, w, nh, nw).apply_segmentation(seg)
    assert_same(got, want)
