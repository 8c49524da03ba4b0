"""The port's JPEG decoder (``drn_wsod_torch/ops/csrc/jpeg_decode.cpp``
through ``drn_wsod_torch/native.py``) against the JAX package's libjpeg
binding (``drn_wsod_tpu.native.jpeg_decode``) and Pillow, on the same
bytes: max |diff| = 0 at every ``scale_num`` 1-8 (the JAX binding) and at
8 (Pillow). Also the committed fixtures' manifest digests, the files the
decoder does not take (each with its reason), ``read_image`` with Pillow
blocked, and the host build arm (``ops/_build.py:build_host``)."""

import hashlib
import io
import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from drn_wsod_torch import native as pnative
from drn_wsod_torch.data import mapper as pmapper
from drn_wsod_torch.ops import _build
from drn_wsod_torch.tools import make_jpeg_fixtures as fixtures
from drn_wsod_tpu import native as jnative
from drn_wsod_tpu.data import mapper as jmapper

FIXTURE_DIR = fixtures.FIXTURE_DIR
MANIFEST = json.loads((FIXTURE_DIR / "manifest.json").read_text())
FILES = sorted(MANIFEST["files"])
DECODED = [f for f in FILES if "reason" not in MANIFEST["files"][f]]


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _image(h, w, seed, mode="RGB"):
    img = fixtures.synthetic_image(h, w, np.random.RandomState(seed))
    im = Image.fromarray(img)
    return im.convert(mode) if mode != "RGB" else im


def _encode(im, **kw):
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _pillow(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _assert_equal_all_scales(data):
    """The port's decode equals the JAX binding's at scales 1-8 (shape and
    values) and Pillow's at 8."""
    assert jnative.jpeg_available()
    for s in range(1, 9):
        want = jnative.jpeg_decode(data, s)
        got = pnative.jpeg_decode(data, s)
        assert want is not None and got is not None, s
        assert got.shape == want.shape, (s, got.shape, want.shape)
        assert np.abs(got.astype(int) - want.astype(int)).max() == 0, s
    np.testing.assert_array_equal(pnative.jpeg_decode(data), _pillow(data))


SIZES = [(37, 53), (61, 77), (75, 101)]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("restart", [None, "blocks3", "rows1"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_decode_equals_jax_and_pillow(subsampling, progressive, restart,
                                      size):
    kw = dict(quality=90, subsampling=subsampling, progressive=progressive)
    if restart == "blocks3":
        kw["restart_marker_blocks"] = 3
    elif restart == "rows1":
        kw["restart_marker_rows"] = 1
    h, w = size
    _assert_equal_all_scales(_encode(_image(h, w, subsampling), **kw))


@pytest.mark.parametrize("kw", [dict(quality=30, optimize=True),
                                dict(quality=95), dict(quality=100),
                                dict(quality=90, keep_rgb=True),
                                dict(quality=90, subsampling="4:1:1")],
                         ids=["q30-optimize", "q95", "q100", "rgb-adobe",
                              "411"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_decode_quality_and_colour(kw, progressive):
    _assert_equal_all_scales(_encode(_image(75, 101, 3), progressive=progressive,
                                     **kw))


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
def test_decode_grayscale(progressive):
    _assert_equal_all_scales(_encode(_image(61, 77, 5, "L"), quality=85,
                                     progressive=progressive))


def test_decode_tiny_and_block_aligned():
    for h, w in ((1, 1), (3, 5), (8, 8), (16, 16), (17, 33)):
        for sub in (0, 2):
            _assert_equal_all_scales(_encode(_image(h, w, h * w),
                                             quality=90, subsampling=sub))


def test_decode_without_dht_uses_standard_tables():
    """A baseline file with its DHT segments removed decodes with the
    standard tables of T.81 Annex K.3, as libjpeg does (Motion-JPEG); the
    encoder wrote those same tables, so the decode is unchanged."""
    data = _encode(_image(61, 77, 7), quality=90)
    out, i = bytearray(data[:2]), 2
    while data[i:i + 2] != b"\xff\xda":
        length = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != 0xC4:
            out += data[i:i + 2 + length]
        i += 2 + length
    stripped = bytes(out + data[i:])
    assert b"\xff\xc4" not in stripped[:stripped.index(b"\xff\xda")]
    got = pnative.jpeg_decode(stripped)
    np.testing.assert_array_equal(got, _pillow(data))
    np.testing.assert_array_equal(got, jnative.jpeg_decode(stripped))


@pytest.mark.parametrize("name", FILES)
def test_fixture_digests(name):
    """Each committed fixture's manifest digests: Pillow's decode at scale
    8, the JAX binding's at 1-8, the port's at 1-8; a file the decoder
    does not take records its reason."""
    entry = MANIFEST["files"][name]
    data = (FIXTURE_DIR / name).read_bytes()
    assert len(data) == entry["bytes"]
    if "reason" in entry:
        assert pnative.jpeg_decode(data) is None
        assert pnative.jpeg_unsupported_reason(data) == entry["reason"]
        return
    h, w, _ = entry["shape"]
    for s in range(1, 9):
        got = pnative.jpeg_decode(data, s)
        assert got.shape == (-(-h * s // 8), -(-w * s // 8), 3)
        assert _digest(got) == entry["sha256"][str(s)], s
        assert _digest(jnative.jpeg_decode(data, s)) == entry["sha256"][str(s)]
    if entry["truncate"] is None:
        assert entry["pillow_sha256"] == entry["sha256"]["8"]
        assert _digest(_pillow(data)) == entry["pillow_sha256"]


def test_fixture_set():
    """The fixtures the decoder takes cover baseline and progressive,
    4:4:4, 4:2:2, 4:2:0, restarts, grayscale and a truncated file; CMYK
    is the one it does not."""
    assert set(MANIFEST["files"]) == set(fixtures.FIXTURES)
    reasons = {f: e.get("reason") for f, e in MANIFEST["files"].items()}
    assert reasons.pop("cmyk_64x48.jpg") == "CMYK JPEG"
    assert set(reasons.values()) == {None}


@pytest.mark.parametrize("fraction", [0.3, 0.45, 0.6, 0.75, 0.9, 0.99])
@pytest.mark.parametrize("restart", [False, True], ids=["plain", "restart"])
def test_truncated_baseline_equals_jax(fraction, restart):
    """A baseline file cut short: the rest of the scan decodes from zero
    bits, then stays gray, as libjpeg (warnings silenced) does."""
    kw = dict(quality=90, restart_marker_blocks=3) if restart else {}
    data = _encode(_image(75, 101, 9), **kw)
    cut = data[:int(len(data) * fraction)]
    for s in (1, 2, 3, 4, 5, 8):
        want = jnative.jpeg_decode(cut, s)
        got = pnative.jpeg_decode(cut, s)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_truncated_progressive():
    """A progressive file cut before its last scans is where libjpeg
    smooths blocks (jdcoefct.c); the port returns None and names it. Cut
    inside its last scan, nothing is smoothed and the decodes agree."""
    data = _encode(_image(75, 101, 10), quality=90, progressive=True)
    early = data[:len(data) // 2]
    assert jnative.jpeg_decode(early) is not None
    assert pnative.jpeg_decode(early) is None
    assert pnative.jpeg_unsupported_reason(early) == "truncated progressive"
    late = data[:int(len(data) * 0.99)]
    np.testing.assert_array_equal(pnative.jpeg_decode(late),
                                  jnative.jpeg_decode(late))


def _with_sof(data, marker=None, precision=None):
    b = bytearray(data)
    i = b.index(b"\xff\xc0")
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    return bytes(b)


@pytest.mark.parametrize("edit,reason", [
    (dict(marker=0xC9), "arithmetic coding"),
    (dict(marker=0xCA), "arithmetic coding"),
    (dict(marker=0xC3), "lossless"),
    (dict(marker=0xC5), "hierarchical"),
    (dict(precision=12), "12-bit"),
], ids=["sof9", "sof10", "sof3", "sof5", "12bit"])
def test_unsupported_headers(edit, reason):
    data = _with_sof(_encode(_image(16, 24, 11), quality=90), **edit)
    assert pnative.jpeg_decode(data) is None
    assert pnative.jpeg_unsupported_reason(data) == reason
    assert pnative.jpeg_decode_info(data) == (24, 16)


def test_cmyk_and_corrupt():
    cmyk = _encode(_image(40, 40, 12).convert("CMYK"), quality=90)
    assert pnative.jpeg_decode(cmyk) is None
    assert jnative.jpeg_decode(cmyk) is None
    assert pnative.jpeg_unsupported_reason(cmyk) == "CMYK JPEG"
    for bad in (b"", b"hello", b"\xff\xd8\xff\xd9", b"\xff\xd8" + b"\0" * 9):
        assert pnative.jpeg_decode(bad) is None
        assert pnative.jpeg_unsupported_reason(bad) == "corrupt header"
    good = _encode(_image(16, 24, 13), quality=90)
    assert pnative.jpeg_unsupported_reason(good) is None
    assert pnative.jpeg_decode(good, 0) is None
    assert pnative.jpeg_decode(good, 9) is None
    assert pnative.jpeg_decode_info(good) == (24, 16)
    assert pnative.jpeg_available()


@pytest.fixture
def no_pillow(monkeypatch):
    """Pillow unimportable, as on the GPU machine."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


@pytest.mark.parametrize("name", DECODED)
def test_read_image_without_pillow(name, no_pillow):
    path = str(FIXTURE_DIR / name)
    want = MANIFEST["files"][name]["sha256"]["8"]
    rgb = pmapper.read_image(path, "RGB")
    bgr = pmapper.read_image(path, "BGR")
    assert _digest(rgb) == want
    assert _digest(bgr[:, :, ::-1]) == want
    assert bgr.flags["C_CONTIGUOUS"]


def test_read_image_names_what_it_cannot_decode(tmp_path, monkeypatch):
    early = tmp_path / "early.jpeg"
    data = _encode(_image(75, 101, 10), quality=90, progressive=True)
    early.write_bytes(data[:len(data) // 2])
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(_with_sof(_encode(_image(16, 24, 11)), marker=0xC9))
    png = tmp_path / "x.png"
    _image(8, 8, 0).save(png)
    bmp = tmp_path / "x.bmp"
    _image(8, 8, 0).save(bmp)
    want_png = np.asarray(_image(8, 8, 0).convert("RGB"))[:, :, ::-1]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ValueError, match="CMYK"):
        pmapper.read_image(str(FIXTURE_DIR / "cmyk_64x48.jpg"))
    with pytest.raises(ValueError, match="truncated progressive"):
        pmapper.read_image(str(early))
    with pytest.raises(ValueError, match=r"arith\.jpg.*arithmetic coding"):
        pmapper.read_image(str(arith))
    # a PNG decodes with the port's own reader since it has one; a format
    # neither reader takes still names Pillow
    np.testing.assert_array_equal(pmapper.read_image(str(png)), want_png)
    with pytest.raises(ImportError, match="Pillow"):
        pmapper.read_image(str(bmp))


@pytest.mark.parametrize("name", FILES)
@pytest.mark.parametrize("fmt", ["RGB", "BGR"])
def test_read_image_equals_jax(name, fmt):
    """With Pillow present both packages' ``read_image`` agree: CMYK
    included (each falls back to Pillow there), and the truncated file
    (which Pillow refuses; each package's decoder takes it)."""
    path = str(FIXTURE_DIR / name)
    np.testing.assert_array_equal(pmapper.read_image(path, fmt),
                                  jmapper.read_image(path, fmt))


def test_build_host_raises(tmp_path, monkeypatch):
    """The host arm raises where there is no compiler or the build fails,
    and rebuilds a library older than its source."""
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "probe.cpp"
    src.write_text('extern "C" int probe() { return 7; }\n')
    info = _build.build_host("probe")
    assert info["built"] and info["compiler"] and info["seconds"] > 0
    assert not _build.build_host("probe")["built"]
    src.write_text('extern "C" int probe() { return 8 }\n')  # a syntax error
    os.utime(_build.library_path("probe"), (1, 1))
    with pytest.raises(RuntimeError, match="host build of probe.cpp failed"):
        _build.build_host("probe")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _build.build_host("probe")
