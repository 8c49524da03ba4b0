"""The port's JPEG decoder (``drn_wsod_torch/ops/csrc/jpeg_decode.cpp``
through ``drn_wsod_torch/native.py``) against the JAX package's libjpeg
binding (``drn_wsod_tpu.native.jpeg_decode``) and Pillow, on the same
bytes: max |diff| = 0 at every ``scale_num`` 1-8 (the JAX binding) and at
8 (Pillow). Arithmetic-coded files (``tools/jpeg_transcode.py``) equal
their Huffman twins; progressive files cut short equal libjpeg's block
smoothing at each cut; CMYK, YCCK and lossless files, which only Pillow
decodes, equal Pillow's ``convert("RGB")`` and mode arrays. Also the
committed fixtures' manifest digests, ``read_image`` with Pillow blocked
against the JAX package's with Pillow present, and the host build arm
(``ops/_build.py:build_host``)."""

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
from drn_wsod_torch.tools import jpeg_transcode as jt
from drn_wsod_torch.tools import make_jpeg_fixtures as fixtures
from drn_wsod_tpu import native as jnative
from drn_wsod_tpu.data import mapper as jmapper

FIXTURE_DIR = fixtures.FIXTURE_DIR
MANIFEST = json.loads((FIXTURE_DIR / "manifest.json").read_text())
FILES = sorted(MANIFEST["files"])
DECODED = [f for f in FILES if MANIFEST["files"][f]["sha256"]]
ARITH = [f for f in FILES if MANIFEST["files"][f]["kind"] == "arithmetic"]


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
    """Each committed fixture's manifest digests: the port's decode at
    every scale it records (1-8 where libjpeg takes the file, where the
    JAX binding's equals it; 8 alone for CMYK, YCCK and lossless, which
    the binding refuses at every scale and the port below 8), Pillow's
    at 8 (none for a file cut short, which Pillow refuses)."""
    entry = MANIFEST["files"][name]
    data = (FIXTURE_DIR / name).read_bytes()
    assert len(data) == entry["bytes"]
    h, w, _ = entry["shape"]
    for s, want in entry["sha256"].items():
        s = int(s)
        got = pnative.jpeg_decode(data, s)
        assert got.shape == (-(-h * s // 8), -(-w * s // 8), 3)
        assert _digest(got) == want, s
    if entry["libjpeg"]:
        assert sorted(entry["sha256"]) == [str(s) for s in range(1, 9)]
        for s in range(1, 9):
            assert _digest(jnative.jpeg_decode(data, s)) == \
                entry["sha256"][str(s)], s
    else:
        assert jnative.jpeg_decode(data) is None
        if entry["sha256"]:
            for s in range(1, 8):
                assert pnative.jpeg_decode_status(data, s) == (None, -12)
    if entry["pillow_sha256"] is None:
        with pytest.raises(OSError):
            _pillow(data)
    else:
        assert _digest(_pillow(data)) == entry["pillow_sha256"]
        if entry["sha256"]:
            assert entry["pillow_sha256"] == entry["sha256"]["8"]


def test_fixture_set():
    """The fixtures cover baseline and progressive, 4:4:4, 4:2:2, 4:2:0,
    restarts, grayscale, files cut short, and now CMYK, YCCK, arithmetic
    coding, progressive files cut at each of the three points, lossless
    files and both misnamed files, each VOC-sized kind under ``voc/``;
    the port decodes every JPEG among them, so none records a reason."""
    assert set(MANIFEST["files"]) == set(fixtures.FIXTURES) | \
        set(fixtures.MADE)
    entries = MANIFEST["files"].values()
    assert all("reason" not in e for e in entries)
    assert {e["kind"] for e in entries} == {
        "pillow", "cmyk", "ycck", "arithmetic", "truncated", "lossless",
        "png"}
    assert MANIFEST["files"]["cmyk_64x48.jpg"]["sha256"].keys() == {"8"}
    cuts = {e["params"]["cut"] for e in entries
            if e["kind"] == "truncated" and "params" in e}
    assert cuts == {"ac1", "between", "refine"}
    voc = {e["kind"] for n, e in MANIFEST["files"].items()
           if n.startswith("voc/")}
    assert voc == {"cmyk", "ycck", "arithmetic", "truncated"}


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
    smooths blocks (jdcoefct.c); the port smooths them as it does, at
    every scale. Cut inside its last scan, nothing is smoothed and the
    decodes agree too."""
    data = _encode(_image(75, 101, 10), quality=90, progressive=True)
    for cut in (data[:len(data) // 2], data[:int(len(data) * 0.99)]):
        assert pnative.jpeg_unsupported_reason(cut) is None
        for s in range(1, 9):
            np.testing.assert_array_equal(pnative.jpeg_decode(cut, s),
                                          jnative.jpeg_decode(cut, s))


@pytest.mark.parametrize("edit,reason", [
    (dict(marker=0xC9), None),
    (dict(marker=0xCA), "corrupt header"),
    (dict(marker=0xC3), "corrupt header"),
    (dict(marker=0xC5), "hierarchical"),
    (dict(precision=12), "12-bit"),
], ids=["sof9", "sof10", "sof3", "sof5", "12bit"])
def test_unsupported_headers(edit, reason):
    """A baseline file's frame header edited: as sequential arithmetic
    (SOF9) both the binding and the port decode its Huffman bits as
    QM-coded data, to the same pixels at every scale; as progressive
    arithmetic (SOF10) its scan (0-63) is no progressive scan, and as
    lossless (SOF3) its scan has no predictor (Ss 0), which every
    reference refuses, as it does hierarchical and 12-bit files."""
    data = jt.edit_sof(_encode(_image(16, 24, 11), quality=90), **edit)
    assert pnative.jpeg_unsupported_reason(data) == reason
    assert pnative.jpeg_decode_info(data) == (24, 16)
    if reason is not None:
        assert pnative.jpeg_decode(data) is None
        assert jnative.jpeg_decode(data) is None
        with pytest.raises(OSError):
            _pillow(data)
    else:
        for s in range(1, 9):
            np.testing.assert_array_equal(pnative.jpeg_decode(data, s),
                                          jnative.jpeg_decode(data, s))


def test_cmyk_and_corrupt():
    """CMYK, which the binding refuses, decodes as Pillow does, at scale
    8 only; a corrupt file is refused by every reference."""
    cmyk = _encode(_image(40, 40, 12).convert("CMYK"), quality=90)
    assert jnative.jpeg_decode(cmyk) is None
    np.testing.assert_array_equal(pnative.jpeg_decode(cmyk), _pillow(cmyk))
    assert pnative.jpeg_unsupported_reason(cmyk) is None
    assert pnative.jpeg_decode(cmyk, 4) is None
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


@pytest.mark.parametrize("name", FILES)
def test_read_image_without_pillow(name, no_pillow):
    """Every fixture, misnamed and Pillow-only ones included, to the
    digest of the JAX package's ``read_image`` with Pillow present."""
    path = str(FIXTURE_DIR / name)
    want = MANIFEST["files"][name]["read_image_sha256"]
    rgb = pmapper.read_image(path, "RGB")
    bgr = pmapper.read_image(path, "BGR")
    assert _digest(rgb) == want
    assert _digest(bgr[:, :, ::-1]) == want
    assert bgr.flags["C_CONTIGUOUS"]


def test_read_image_names_what_it_cannot_decode(tmp_path, monkeypatch):
    """Without Pillow, ``read_image`` decodes what either reference
    decodes (a progressive file cut short, arithmetic coding, CMYK, a
    PNG), names the file and the feature where both refuse (12-bit), and
    names Pillow for a format neither of the port's readers takes."""
    early = tmp_path / "early.jpeg"
    data = _encode(_image(75, 101, 10), quality=90, progressive=True)
    early.write_bytes(data[:len(data) // 2])
    arith = tmp_path / "arith.jpg"
    arith.write_bytes(jt.arithmetic(_encode(_image(16, 24, 11))))
    deep = tmp_path / "deep.jpg"
    deep.write_bytes(jt.edit_sof(_encode(_image(16, 24, 11)), precision=12))
    png = tmp_path / "x.png"
    _image(8, 8, 0).save(png)
    bmp = tmp_path / "x.bmp"
    _image(8, 8, 0).save(bmp)
    want_png = np.asarray(_image(8, 8, 0).convert("RGB"))[:, :, ::-1]
    want = {p: jmapper.read_image(str(p)) for p in (early, arith)}
    want_cmyk = _pillow((FIXTURE_DIR / "cmyk_64x48.jpg").read_bytes())
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    np.testing.assert_array_equal(
        pmapper.read_image(str(FIXTURE_DIR / "cmyk_64x48.jpg"), "RGB"),
        want_cmyk)
    for p, a in want.items():
        np.testing.assert_array_equal(pmapper.read_image(str(p)), a)
    with pytest.raises(ValueError, match=r"deep\.jpg.*12-bit"):
        pmapper.read_image(str(deep))
    # a PNG decodes with the port's own reader; a format neither reader
    # takes still names Pillow
    np.testing.assert_array_equal(pmapper.read_image(str(png)), want_png)
    with pytest.raises(ImportError, match="Pillow"):
        pmapper.read_image(str(bmp))


@pytest.mark.parametrize("name", FILES)
@pytest.mark.parametrize("fmt", ["RGB", "BGR"])
def test_read_image_equals_jax(name, fmt):
    """With Pillow present both packages' ``read_image`` agree: CMYK
    included (the JAX package falls back to Pillow there, the port
    decodes it itself), and the truncated files (which Pillow refuses;
    each package's decoder takes them); the JAX package's decode is the
    manifest's ``read_image_sha256``."""
    path = str(FIXTURE_DIR / name)
    want = jmapper.read_image(path, fmt)
    np.testing.assert_array_equal(pmapper.read_image(path, fmt), want)
    rgb = want if fmt == "RGB" else want[:, :, ::-1]
    assert _digest(rgb) == MANIFEST["files"][name]["read_image_sha256"]


@pytest.mark.parametrize("name", FILES)
def test_read_image_without_pillow_equals_jax(name, monkeypatch):
    """The port's ``read_image`` with Pillow blocked against the JAX
    package's with Pillow present: max |diff| = 0."""
    path = str(FIXTURE_DIR / name)
    want = jmapper.read_image(path, "RGB")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got = pmapper.read_image(path, "RGB")
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() == 0


@pytest.mark.parametrize("name", ARITH)
def test_arithmetic_fixture_equals_twin(name):
    """Each arithmetic fixture and its Huffman twin decode to the same
    pixels at every scale, in the binding and in the port."""
    twin = MANIFEST["files"][name]["params"]["twin"]
    data = (FIXTURE_DIR / name).read_bytes()
    huff = (FIXTURE_DIR / twin).read_bytes()
    for s in range(1, 9):
        want = jnative.jpeg_decode(huff, s)
        np.testing.assert_array_equal(jnative.jpeg_decode(data, s), want)
        np.testing.assert_array_equal(pnative.jpeg_decode(data, s), want)
        np.testing.assert_array_equal(pnative.jpeg_decode(huff, s), want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("coding", [
    dict(progressive=False), dict(progressive=True),
    dict(progressive=False, restart=3, dac=fixtures.DAC),
    dict(progressive=True, restart=2, dac=fixtures.DAC)],
    ids=["sequential", "progressive", "sequential-restart-dac",
         "progressive-restart-dac"])
@pytest.mark.parametrize("subsampling", [0, 1, 2, "gray"],
                         ids=["444", "422", "420", "gray"])
def test_arithmetic_equals_twin(subsampling, coding, size):
    """Files re-encoded with the QM coder (``jpeg_transcode``): equal to
    their Huffman twin at every scale, in the binding and in the port."""
    h, w = size
    if subsampling == "gray":
        huff = _encode(_image(h, w, 21, "L"), quality=90)
    else:
        huff = _encode(_image(h, w, 21), quality=90, subsampling=subsampling)
    data = jt.arithmetic(huff, **coding)
    for s in range(1, 9):
        want = jnative.jpeg_decode(huff, s)
        np.testing.assert_array_equal(jnative.jpeg_decode(data, s), want)
        np.testing.assert_array_equal(pnative.jpeg_decode(data, s), want)


@pytest.mark.parametrize("cut", ["ac1", "between", "refine", 0.3, 0.55,
                                 0.8, 0.95])
@pytest.mark.parametrize("layout", [(75, 101, 2), (61, 77, 0), (77, 61, 1),
                                    (40, 33, "gray"), (120, 160, 2)],
                         ids=["101x75-420", "77x61-444", "61x77-422",
                              "33x40-gray", "160x120-420"])
def test_block_smoothing_equals_jax(layout, cut):
    """Progressive files cut inside the first AC scan, between scans,
    inside a refinement scan and at fractions of their length: libjpeg's
    block smoothing, bit for bit at every scale."""
    h, w, sub = layout
    if sub == "gray":
        data = _encode(_image(h, w, 22, "L"), quality=90, progressive=True)
    else:
        data = _encode(_image(h, w, 22), quality=90, subsampling=sub,
                       progressive=True)
    if isinstance(cut, float):
        data = data[:int(len(data) * cut)]
    else:
        data = data[:fixtures.cut_point(data, cut)]
    for s in range(1, 9):
        want = jnative.jpeg_decode(data, s)
        got = pnative.jpeg_decode(data, s)
        if want is None:
            assert got is None
            continue
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() == 0, s


@pytest.mark.parametrize("size", [(40, 56), (37, 61), (17, 9), (64, 48)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("subsampling", [None, 0, 1, 2],
                         ids=["default", "444", "422", "420"])
@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("transform", [0, 2], ids=["cmyk", "ycck"])
def test_four_components_equal_pillow(transform, progressive, subsampling,
                                      size):
    """CMYK (Adobe transform 0) and YCCK (2): equal to Pillow's
    ``convert("RGB")`` and, as a label map, to its "CMYK" array (libjpeg's
    YCCK -> CMYK, inverted); the binding refuses them."""
    kw = dict(quality=90, progressive=progressive)
    if subsampling is not None:
        kw["subsampling"] = subsampling
    h, w = size
    data = _encode(_image(h, w, 23, "CMYK"), **kw)
    i = data.index(b"Adobe") + 11
    data = data[:i] + bytes([transform]) + data[i + 1:]
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "CMYK"
        want_rgb, want = np.asarray(im.convert("RGB")), np.asarray(im)
    assert jnative.jpeg_decode(data) is None
    np.testing.assert_array_equal(pnative.jpeg_decode(data), want_rgb)
    np.testing.assert_array_equal(pnative.jpeg_decode_status(data, 8, native=True)[0], want)


@pytest.mark.parametrize("predictor", range(1, 8))
@pytest.mark.parametrize("pt,restart_rows", [(0, 0), (1, 3), (3, 1)])
@pytest.mark.parametrize("colour", ["gray", "rgb", "none", "cmyk"])
def test_lossless_equals_pillow(colour, pt, restart_rows, predictor):
    """Lossless (SOF3) 8-bit files, which the binding refuses: every
    predictor, point transforms, restarts; gray, RGB (Adobe transform 0
    or no marker, as libjpeg-turbo 3 reads three lossless components)
    and CMYK; equal to Pillow's ``convert("RGB")`` and mode array."""
    x = fixtures.synthetic_image(20, 27, np.random.RandomState(predictor))
    samples = {"gray": x[..., 0], "rgb": x, "none": x,
               "cmyk": np.concatenate([x, x[..., :1] ^ 0x55], -1)}[colour]
    data = jt.lossless(samples, predictor, pt, restart_rows,
                       "rgb" if colour == "rgb" else "none")
    with Image.open(io.BytesIO(data)) as im:
        want_rgb, want = np.asarray(im.convert("RGB")), np.asarray(im)
    assert jnative.jpeg_decode(data) is None
    np.testing.assert_array_equal(pnative.jpeg_decode(data), want_rgb)
    np.testing.assert_array_equal(pnative.jpeg_decode_status(data, 8, native=True)[0], want)


@pytest.mark.parametrize("hv", [(0x22, 0x11, 0x11), (0x21, 0x11, 0x11),
                                (0x12, 0x11, 0x11), (0x41, 0x21, 0x11),
                                (0x22, 0x22, 0x11)],
                         ids=["2x2", "2x1", "1x2", "4x1", "2x2-2x2"])
@pytest.mark.parametrize("size", [(20, 24), (13, 7), (17, 31)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
def test_lossless_sampling_equals_pillow(size, hv):
    """Subsampled lossless files: Pillow upsamples them by replication
    (libjpeg-turbo 3 has no fancy upsampling of one-sample data units)."""
    h, w = size
    x = fixtures.synthetic_image(h, w, np.random.RandomState(w))
    hs, vs = [v >> 4 for v in hv], [v & 15 for v in hv]
    planes = [np.ascontiguousarray(x[::max(vs) // v, ::max(hs) // hh, i])
              for i, (hh, v) in enumerate(zip(hs, vs))]
    for predictor, restart_rows in ((1, 0), (4, 2), (7, 0)):
        data = jt.lossless(planes, predictor, 0, restart_rows, "rgb", hv)
        np.testing.assert_array_equal(pnative.jpeg_decode(data),
                                      _pillow(data))


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
