"""What each reference decodes, and the port beside it: every image file
the JAX package's ``read_image`` (its libjpeg binding, then Pillow) and
the ``imagenet`` tool (Pillow) decode, the port decodes with Pillow
blocked, bit-equal; where both references refuse a file, the port refuses
it too and names the file and the feature.

``ROWS`` is the table, one feature a row: whether the binding
(``drn_wsod_tpu.native.jpeg_decode``) decodes the file, whether Pillow
does (``convert("RGB")``), and whether the port's ``read_image`` does with
Pillow blocked. ``test_reference_table`` holds every cell to a run; run
this file as a script to print the table:

    JAX_PLATFORMS=cpu python tests/test_torch_image_formats.py

Also the refusals both references share (``native.REASONS`` holds those
and no other feature), the misnamed files, ``read_label_map`` on 16-bit,
interlaced and JPEG label maps, and the ``imagenet`` tool's loader over a
tree with CMYK, YCCK and a PNG named ``.JPEG`` against the JAX tool's.
"""

import importlib.util
import io
import os
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from drn_wsod_torch import native as pnative
from drn_wsod_torch.data import mapper as pmapper
from drn_wsod_torch.tools import jpeg_transcode as jt
from drn_wsod_torch.tools import make_png_fixtures as pf
from drn_wsod_torch.tools.make_jpeg_fixtures import (FIXTURE_DIR,
                                                     synthetic_image)
from drn_wsod_tpu import native as jnative
from drn_wsod_tpu.data import mapper as jmapper

ROOT = Path(__file__).resolve().parents[1]


def _rgb(h, w, seed):
    return synthetic_image(h, w, np.random.RandomState(seed))


def _save(a, mode=None, **kw):
    im = Image.fromarray(a)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def _cmyk(transform=0, **kw):
    data = _save(_rgb(40, 56, 2), "CMYK", quality=90, **kw)
    i = data.index(b"Adobe") + 11
    return data[:i] + bytes([transform]) + data[i + 1:]


def _base():
    return _save(_rgb(40, 56, 1), quality=90)


def _progressive():
    return _save(_rgb(75, 101, 3), quality=90, progressive=True)


def _png(colour, depth, ch, interlace):
    rng = np.random.RandomState(colour * 100 + depth)
    palette = rng.randint(0, 256, (min(1 << depth, 200), 3)) \
        if colour == 3 else None
    return pf.encode_png(rng.randint(0, 1 << depth, (13, 17, ch)), colour,
                         depth, palette, filters=(0, 1, 2, 3, 4),
                         interlace=interlace)


_PNG_KINDS = {"gray": (0, 1), "palette": (3, 1), "gray+alpha": (4, 2),
              "RGB": (2, 3), "RGBA": (6, 4)}


def _rows():
    """[(feature, file name, bytes)], each built from a seed."""
    gray = _rgb(20, 24, 4)[..., 0]
    rgb = _rgb(20, 24, 4)
    rows = [
        ("CMYK", "cmyk.jpg", _cmyk(0)),
        ("YCCK", "ycck.jpg", _cmyk(2)),
        ("arithmetic sequential", "arith.jpg", jt.arithmetic(_base())),
        ("arithmetic progressive", "arith_prog.jpg",
         jt.arithmetic(_base(), True)),
        ("truncated progressive (50%)", "cut.jpg",
         _progressive()[:len(_progressive()) // 2]),
        ("lossless (SOF3) 8-bit gray", "lossless_gray.jpg",
         jt.lossless(gray, 7)),
        ("lossless (SOF3) 8-bit RGB", "lossless_rgb.jpg",
         jt.lossless(rgb, 4, colour="rgb")),
        ("lossless (SOF3) 8-bit YCbCr (JFIF)", "lossless_ycc.jpg",
         jt.lossless(rgb, 4, colour="ycc")),
        ("lossless 12-bit", "lossless12.jpg",
         jt.edit_sof(jt.lossless(gray, 1), precision=12)),
        ("lossless arithmetic (SOF11)", "sof11.jpg",
         jt.edit_sof(jt.lossless(gray, 1), marker=0xCB)),
        ("12-bit (SOF1)", "deep.jpg",
         jt.edit_sof(_base(), marker=0xC1, precision=12)),
        ("hierarchical (SOF5)", "sof5.jpg", jt.edit_sof(_base(),
                                                        marker=0xC5)),
        ("hierarchical arithmetic (SOF13)", "sof13.jpg",
         jt.edit_sof(_base(), marker=0xCD)),
        ("kSampling: 3x1 luma, 2x1 chroma", "sampling.jpg",
         jt.edit_sof(_base(), sampling=(0x31, 0x21, 0x21))),
        ("kSampling: 11 blocks an MCU (3x3, 1x1)", "mcu11.jpg",
         jt.edit_sof(_base(), sampling=(0x33, 0x11, 0x11))),
        ("kComponents: 2", "two.jpg", jt.edit_sof(_base(), components=2)),
        ("kComponents: 5", "five.jpg", jt.edit_sof(_base(), components=5)),
        ("CMYK cut short", "cmyk_cut.jpg", _cmyk(0)[:-300]),
        ("lossless cut short", "lossless_cut.jpg",
         jt.lossless(gray, 7)[:-40]),
        ("corrupt header", "corrupt.jpg", b"\xff\xd8" + bytes(9)),
    ]
    for kind, (colour, ch) in _PNG_KINDS.items():
        depths = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(colour, (8, 16))
        for depth in depths:
            rows.append((f"Adam7 PNG {kind} {depth}-bit",
                         f"adam7_{colour}_{depth}.png",
                         _png(colour, depth, ch, True)))
    for kind, (colour, ch) in _PNG_KINDS.items():
        if colour != 3:
            rows.append((f"16-bit PNG {kind}", f"wide_{colour}.png",
                         _png(colour, 16, ch, False)))
    rows += [
        ("PNG named .JPEG", "x.JPEG", pf.encode_png(rgb, 2, 8)),
        ("PNG named .jpg", "x.jpg", pf.encode_png(rgb, 2, 8)),
        ("JPEG named .png", "y.png", _base()),
        ("CMYK JPEG named .png", "z.png", _cmyk(0)),
    ]
    return rows


ROWS = _rows()

# feature -> (binding decodes, Pillow decodes, the port decodes), each
# from a run (test_reference_table)
TABLE = {
    "CMYK": (False, True, True),
    "YCCK": (False, True, True),
    "arithmetic sequential": (True, True, True),
    "arithmetic progressive": (True, True, True),
    "truncated progressive (50%)": (True, False, True),
    "lossless (SOF3) 8-bit gray": (False, True, True),
    "lossless (SOF3) 8-bit RGB": (False, True, True),
    "lossless (SOF3) 8-bit YCbCr (JFIF)": (False, False, False),
    "lossless 12-bit": (False, False, False),
    "lossless arithmetic (SOF11)": (False, False, False),
    "12-bit (SOF1)": (False, False, False),
    "hierarchical (SOF5)": (False, False, False),
    "hierarchical arithmetic (SOF13)": (False, False, False),
    "kSampling: 3x1 luma, 2x1 chroma": (False, False, False),
    "kSampling: 11 blocks an MCU (3x3, 1x1)": (False, False, False),
    "kComponents: 2": (False, False, False),
    "kComponents: 5": (False, False, False),
    "CMYK cut short": (False, False, False),
    "lossless cut short": (False, False, False),
    "corrupt header": (False, False, False),
    "PNG named .JPEG": (False, True, True),
    "PNG named .jpg": (False, True, True),
    "JPEG named .png": (True, True, True),
    "CMYK JPEG named .png": (False, True, True),
}
TABLE.update({r[0]: (False, True, True) for r in ROWS
              if r[0].startswith(("Adam7", "16-bit"))})
REFUSED = [r for r in ROWS if not any(TABLE[r[0]])]


def _binding(data):
    return jnative.jpeg_decode(data) is not None


def _pillow(data):
    try:
        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))
    except (OSError, SyntaxError, ValueError):
        return None


def _port(path):
    """The port's ``read_image`` (RGB) with Pillow blocked, or the
    exception it raises."""
    saved = {k: sys.modules.get(k) for k in ("PIL", "PIL.Image")}
    sys.modules.update(dict.fromkeys(saved))
    try:
        return pmapper.read_image(str(path), "RGB")
    except (ValueError, ImportError) as e:
        return e
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@pytest.mark.parametrize("feature,name,data", ROWS, ids=[r[0] for r in ROWS])
def test_reference_table(feature, name, data, tmp_path):
    """Each cell of the table from a run; where either reference decodes
    the file, the port's decode with Pillow blocked equals the JAX
    package's ``read_image`` with Pillow present."""
    path = tmp_path / name
    path.write_bytes(data)
    got = _port(path)
    cells = (_binding(data), _pillow(data) is not None,
             isinstance(got, np.ndarray))
    assert cells == TABLE[feature]
    if cells[2]:
        want = jmapper.read_image(str(path), "RGB")
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() == 0


@pytest.mark.parametrize("feature,name,data", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_shared_refusals(feature, name, data, tmp_path):
    """Every refusal that remains: the binding returns None, Pillow and
    the JAX package's ``read_image`` raise, and the port's ``read_image``
    raises a ``ValueError`` naming the file and a feature of
    ``native.REASONS``."""
    path = tmp_path / name
    path.write_bytes(data)
    assert jnative.jpeg_decode(data) is None
    assert _pillow(data) is None
    with pytest.raises(Exception):
        jmapper.read_image(str(path))
    got = _port(path)
    assert isinstance(got, ValueError)
    reason = pnative.jpeg_unsupported_reason(data)
    assert reason in pnative.REASONS.values()
    assert name in str(got) and reason in str(got)


def test_reasons_are_the_shared_refusals():
    """``native.REASONS`` names the refusals of the table and the two
    errors of a call (scale_num, the buffer), no feature either
    reference decodes; every reason but those two shows in a row, or is
    the Pillow-only kinds' scales below 8, where the binding refuses
    too."""
    seen = {pnative.jpeg_unsupported_reason(d) for _, _, d in REFUSED}
    calls = {pnative.REASONS[-2], pnative.REASONS[-3]}
    below8 = pnative.REASONS[-12]
    assert seen | calls | {below8} == set(pnative.REASONS.values())
    for _, _, data in ROWS[:2] + ROWS[5:7]:      # CMYK, YCCK, lossless
        for s in range(1, 8):
            assert jnative.jpeg_decode(data, s) is None
            assert pnative.jpeg_decode_status(data, s) == (None, -12)


@pytest.mark.parametrize("name", ["misnamed_png.JPEG", "misnamed_jpeg.png"])
def test_misnamed_fixtures(name, monkeypatch):
    """The committed misnamed pair: the port's ``read_image`` (Pillow
    blocked) and ``read_label_map`` against the JAX package's
    ``read_image`` and ``np.asarray(Image.open(f))``."""
    path = str(FIXTURE_DIR / name)
    want = jmapper.read_image(path, "BGR")
    with Image.open(path) as im:
        want_map = np.asarray(im)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    np.testing.assert_array_equal(pmapper.read_image(path), want)
    np.testing.assert_array_equal(pmapper.read_label_map(path), want_map)


def _label_maps():
    names = [f"modes/{n}" for n in ("gray16.png", "adam7_gray16.png",
                                     "adam7_palette4.png", "adam7_gray8.png",
                                     "rgb16.png", "gray_alpha16.png",
                                     "adam7_rgba16.png")]
    return [pf.FIXTURE_DIR / n for n in names] + [
        FIXTURE_DIR / n for n in ("gray_75x101.jpg", "odd_61x77_420.jpg",
                                  "cmyk_64x48.jpg", "ycck_64x48.jpg",
                                  "lossless_gray_33x40.jpg",
                                  "lossless_rgb_33x40.jpg")]


@pytest.mark.parametrize("path", _label_maps(), ids=lambda p: p.name)
def test_read_label_map_without_pillow(path, monkeypatch):
    """``read_label_map`` with Pillow blocked equals ``np.asarray(Image.
    open(f))``, dtype and shape included: 16-bit gray (uint16), Adam7,
    palette indices, and JPEGs in Pillow's mode (L, RGB, CMYK)."""
    with Image.open(path) as im:
        want = np.asarray(im)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    got = pmapper.read_label_map(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _jax_imagenet():
    spec = importlib.util.spec_from_file_location(
        "jax_imagenet_tool", ROOT / "tools" / "imagenet.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_imagenet_loader_equals_jax_tool(tmp_path, monkeypatch):
    """The ``imagenet`` tool's loader at toy width (32 px) over a
    two-class tree holding a CMYK file, a YCCK file and a PNG named
    ``.JPEG`` beside baseline JPEGs: with Pillow blocked, the port's
    batches equal the JAX tool's (Pillow's decode and bilinear resize),
    the listing sorted in both as the port sorts it."""
    from drn_wsod_torch.tools import imagenet as pim

    root = tmp_path / "train"
    files = {"n01/a.JPEG": _save(_rgb(40, 50, 5), quality=90),
             "n01/b.JPEG": _cmyk(0),
             "n01/c.JPEG": pf.encode_png(_rgb(37, 45, 6), 2, 8),
             "n02/d.JPEG": _cmyk(2),
             "n02/e.JPEG": _save(_rgb(33, 61, 7), quality=75),
             "n02/f.JPEG": jt.arithmetic(_save(_rgb(30, 41, 8),
                                               quality=90))}
    for rel, data in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    jtool = _jax_imagenet()
    listdir = os.listdir
    monkeypatch.setattr(jtool.os, "listdir",
                        lambda p: sorted(listdir(p)), raising=False)
    want = [(np.asarray(x), np.asarray(y)) for x, y in
            (next(g) for g in [jtool.imagefolder_batches(str(root), 3, 32)]
             * 2)]
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    batches = pim.imagefolder_batches(str(root), 3, 32)
    for wx, wy in want:
        x, y = next(batches)
        np.testing.assert_array_equal(y, wy)
        assert x.dtype == np.float32 and x.shape == wx.shape
        np.testing.assert_array_equal(x, wx)


def main():
    """Print the table, each cell from this run."""
    import tempfile

    print("| feature | binding decodes | Pillow decodes | port's "
          "read_image, no Pillow |")
    print("|---|---|---|---|")
    with tempfile.TemporaryDirectory() as d:
        for feature, name, data in ROWS:
            path = Path(d) / name
            path.write_bytes(data)
            got = _port(path)
            port = "yes" if isinstance(got, np.ndarray) else \
                f"raises ({type(got).__name__})"
            pil = "yes" if _pillow(data) is not None else "raises"
            print(f"| {feature} | {'yes' if _binding(data) else 'no'} | "
                  f"{pil} | {port} |")


if __name__ == "__main__":
    main()
