"""A PNG reader that needs no Pillow (the label maps of the semantic and
panoptic datasets, and PNG images).

:func:`decode_png` returns what ``np.asarray(Image.open(f))`` returns for
the files it takes, non-interlaced at 1-8 bits a sample:

  * gray ("L", (H, W) uint8; at 1 bit Pillow's mode "1", a bool array; at 2
    and 4 bits the samples scaled to 0-255 by 85 and 17, as Pillow's "L;2"
    and "L;4" unpackers do);
  * palette ("P", (H, W) uint8 indices at 1, 2, 4 or 8 bits);
  * gray with alpha ("LA", (H, W, 2)), RGB ((H, W, 3)) and RGBA
    ((H, W, 4)), all uint8.

:func:`decode_png_rgb` returns ``Image.open(f).convert("RGB")``: gray
replicated (0/255 at 1 bit), the alpha dropped, a palette index looked up
in the PLTE colours (black past its end). The inflate is the standard
library's ``zlib``; the row filters undo in host C++
(``ops/csrc/png_unfilter.cpp``, built by ``ops/_build.py:build_host``),
whose numpy twin is :func:`unfilter_plain`. A CRC, a zlib stream or a
chunk layout that does not check raises ``ValueError``.

:func:`encode_png` and :func:`write_png` write 8-bit gray, RGB and RGBA
arrays (filter type 0 on every row, ``zlib`` at level 6): the file reads
back exactly here and through Pillow.

Interlaced (Adam7) and 16-bit files raise :class:`PNGUnsupported`;
:func:`read_png` and :func:`read_png_rgb` then fall back to Pillow where it
imports, and otherwise raise a ``ValueError`` naming the file and the
feature, as ``mapper.read_image`` does for the JPEGs its decoder does not
take.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Tuple

import numpy as np

from ..ops import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type (gray, RGB, palette, gray+alpha, RGBA) -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


class PNGUnsupported(ValueError):
    """A valid PNG this reader does not take (interlaced, 16-bit)."""


def _unfilter_fn():
    return _build.bind_host("png_unfilter", "png_unfilter", _u8p,
                            ctypes.c_size_t, _u8p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int)


def unfilter(raw: np.ndarray, height: int, stride: int, bpp: int
             ) -> np.ndarray:
    """The inflated stream (height rows of a filter byte and ``stride``
    bytes) -> (height, stride) uint8 scanlines, in host C++."""
    out = np.empty((height, stride), np.uint8)
    rc = _unfilter_fn()(np.ascontiguousarray(raw), raw.size, out.reshape(-1),
                        height, stride, bpp)
    if rc == -1:
        raise ValueError("PNG image data is truncated")
    if rc:
        raise ValueError(f"PNG row filter type {-rc - 10} is invalid")
    return out


def unfilter_plain(raw: np.ndarray, height: int, stride: int, bpp: int
                   ) -> np.ndarray:
    """:func:`unfilter` in numpy (the C++ version's twin): None, Sub and
    Up a row at a time, Average and Paeth a pixel (``bpp`` bytes) at a
    time."""
    if raw.size < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = raw[:height * (stride + 1)].reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        t, src = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if t == 0:
            cur = src
        elif t == 1:
            lanes = np.zeros(-(-stride // bpp) * bpp, np.int32)
            lanes[:stride] = src
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0).reshape(-1)[
                :stride]
        elif t == 2:
            cur = src + prev
        elif t in (3, 4):
            cur = np.zeros(stride, np.int32)
            for i in range(0, stride, bpp):
                j = slice(i, min(i + bpp, stride))
                n = j.stop - j.start
                a = cur[i - bpp:i - bpp + n] if i >= bpp else 0
                b = prev[j]
                if t == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[i - bpp:i - bpp + n] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[j] = (src[j] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row filter type {t} is invalid")
        prev = cur & 0xFF
        out[y] = prev
    return out


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or pos + 12 + length > len(data):
            raise ValueError(f"PNG chunk {kind!r} is truncated")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _parse(data: bytes):
    """(header dict, palette (n, 3) uint8 or None, IDAT bytes)."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, colour, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", body)
            if colour not in _CHANNELS or depth not in _DEPTHS[colour] or \
                    comp or filt or interlace > 1 or not w or not h:
                raise ValueError(f"PNG header is invalid: {w}x{h}, depth "
                                 f"{depth}, colour type {colour}")
            header = dict(width=w, height=h, depth=depth, colour=colour,
                          interlace=interlace)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError("PNG file has no IHDR or no IDAT chunk")
    if header["colour"] == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    return header, palette, b"".join(idat)


def _decode(data: bytes, plain: bool = False) -> Tuple[np.ndarray, dict,
                                                       np.ndarray]:
    """(samples (H, W, channels) uint8, header, palette)."""
    hd, palette, idat = _parse(data)
    if hd["interlace"]:
        raise PNGUnsupported("interlaced (Adam7) PNG")
    if hd["depth"] == 16:
        raise PNGUnsupported("16-bit PNG")
    H, W, depth = hd["height"], hd["width"], hd["depth"]
    ch = _CHANNELS[hd["colour"]]
    stride = -(-W * ch * depth // 8)
    bpp = max(1, ch * depth // 8)
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    rows = (unfilter_plain if plain else unfilter)(raw, H, stride, bpp)
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)
        samples = bits[:, :W * depth].reshape(H, W, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        out = (samples * weights).sum(-1, dtype=np.uint8)[..., None]
    else:
        out = rows[:, :W * ch].reshape(H, W, ch)
    return out, hd, palette


def decode_png(data: bytes, plain: bool = False) -> np.ndarray:
    """PNG bytes -> ``np.asarray(Image.open(...))`` (module docstring).
    ``plain`` undoes the filters in numpy instead of C++."""
    out, hd, _ = _decode(data, plain)
    if hd["colour"] == 0:
        g = out[..., 0]
        if hd["depth"] == 1:
            return g.astype(bool)
        return g * np.uint8(255 // ((1 << hd["depth"]) - 1))
    if hd["colour"] == 3:
        return out[..., 0]
    return out


def decode_png_rgb(data: bytes, plain: bool = False) -> np.ndarray:
    """PNG bytes -> ``np.asarray(Image.open(...).convert("RGB"))``,
    (H, W, 3) uint8."""
    out, hd, palette = _decode(data, plain)
    if hd["colour"] == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[out[..., 0]]
    if hd["colour"] in (0, 4):
        g = out[..., 0]
        if hd["colour"] == 0:
            g = g * np.uint8(255 // ((1 << hd["depth"]) - 1))
        return np.repeat(g[..., None], 3, axis=-1)
    return np.ascontiguousarray(out[..., :3])


def _read(path: str, rgb: bool) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png_rgb(data) if rgb else decode_png(data)
    except PNGUnsupported as e:
        try:
            from PIL import Image
        except ImportError:
            raise ValueError(
                f"cannot decode {path!r}: {e} is not taken by the port's "
                "PNG reader, and Pillow is not installed to fall back "
                "on") from None
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB") if rgb else im)
    except ValueError as e:
        raise ValueError(f"cannot decode {path!r}: {e}") from None


def read_png(path: str) -> np.ndarray:
    """The PNG file at ``path`` as ``np.asarray(Image.open(path))``."""
    return _read(path, rgb=False)


def read_png_rgb(path: str) -> np.ndarray:
    """The PNG file at ``path`` as ``Image.open(path).convert("RGB")``."""
    return _read(path, rgb=True)


_COLOUR_OF = {1: 0, 3: 2, 4: 6}   # samples a pixel -> colour type


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[..., None]
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in _COLOUR_OF \
            or 0 in a.shape[:2]:
        raise ValueError(f"encode_png takes (H, W), (H, W, 3) or (H, W, 4) "
                         f"uint8, got {np.asarray(image).shape} {a.dtype}")
    h, w, c = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(a).reshape(h, w * c)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_OF[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """Write ``image`` (see :func:`encode_png`) to ``path``."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)
