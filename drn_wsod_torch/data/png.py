"""A PNG reader that needs no Pillow (the label maps of the semantic and
panoptic datasets, and PNG images).

:func:`decode_png` returns what ``np.asarray(Image.open(f))`` returns for
every PNG, plain or interlaced (Adam7, each of its seven passes unfiltered
on its own and its pixels put in place), at 1-16 bits a sample:

  * gray ("L", (H, W) uint8; at 1 bit Pillow's mode "1", a bool array; at 2
    and 4 bits the samples scaled to 0-255 by 85 and 17, as Pillow's "L;2"
    and "L;4" unpackers do; at 16 bits "I;16", (H, W) uint16);
  * palette ("P", (H, W) uint8 indices at 1, 2, 4 or 8 bits);
  * gray with alpha ("LA", (H, W, 2)), RGB ((H, W, 3)) and RGBA
    ((H, W, 4)), all uint8; at 16 bits each sample's high byte, and gray
    with alpha as RGBA (Pillow's "LA;16B" and "RGB(A);16B" raw modes).

:func:`decode_png_rgb` returns ``Image.open(f).convert("RGB")``: gray
replicated (0/255 at 1 bit, 16-bit gray clipped at 255), the alpha
dropped, a palette index looked up in the PLTE colours (black past its
end). The inflate is the standard library's ``zlib``; the row filters undo
in host C++ (``ops/csrc/png_unfilter.cpp``, built by
``ops/_build.py:build_host``), whose numpy twin is :func:`unfilter_plain`.
A CRC, a zlib stream or a chunk layout that does not check raises
``ValueError``; :func:`read_png` and :func:`read_png_rgb` name the file.

:func:`encode_png` and :func:`write_png` write 8-bit gray, RGB and RGBA
arrays (filter type 0 on every row, ``zlib`` at level 6): the file reads
back exactly here and through Pillow.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Tuple

import numpy as np

from ..ops import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# colour type (gray, RGB, palette, gray+alpha, RGBA) -> samples a pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


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


def _samples(rows: np.ndarray, width: int, depth: int, ch: int
             ) -> np.ndarray:
    """Unfiltered scanlines -> (rows, width, ch) samples: uint8 at 1-8 bits,
    uint16 at 16."""
    h = rows.shape[0]
    if depth < 8:
        bits = np.unpackbits(rows, axis=1)
        samples = bits[:, :width * depth].reshape(h, width, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        return (samples * weights).sum(-1, dtype=np.uint8)[..., None]
    if depth == 16:
        return rows[:, :width * ch * 2].view(">u2").astype(np.uint16) \
            .reshape(h, width, ch)
    return rows[:, :width * ch].reshape(h, width, ch)


def _decode(data: bytes, plain: bool = False) -> Tuple[np.ndarray, dict,
                                                       np.ndarray]:
    """(samples (H, W, channels), uint8 or at 16 bits uint16, header,
    palette)."""
    hd, palette, idat = _parse(data)
    H, W, depth = hd["height"], hd["width"], hd["depth"]
    ch = _CHANNELS[hd["colour"]]
    bpp = max(1, ch * depth // 8)
    try:
        raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    unfilter_fn = unfilter_plain if plain else unfilter
    if not hd["interlace"]:
        rows = unfilter_fn(raw, H, -(-W * ch * depth // 8), bpp)
        return _samples(rows, W, depth, ch), hd, palette
    out = np.zeros((H, W, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        pw, ph = -(-(W - x0) // dx), -(-(H - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue            # an empty pass has no scanlines
        stride = -(-pw * ch * depth // 8)
        rows = unfilter_fn(raw[pos:], ph, stride, bpp)
        pos += ph * (stride + 1)
        out[y0::dy, x0::dx] = _samples(rows, pw, depth, ch)
    return out, hd, palette


def decode_png(data: bytes, plain: bool = False) -> np.ndarray:
    """PNG bytes -> ``np.asarray(Image.open(...))`` (module docstring).
    ``plain`` undoes the filters in numpy instead of C++."""
    out, hd, _ = _decode(data, plain)
    if hd["colour"] == 0:
        g = out[..., 0]
        if hd["depth"] == 1:
            return g.astype(bool)
        if hd["depth"] == 16:
            return g
        return g * np.uint8(255 // ((1 << hd["depth"]) - 1))
    if hd["colour"] == 3:
        return out[..., 0]
    if hd["depth"] == 16:
        out = (out >> 8).astype(np.uint8)
        if hd["colour"] == 4:
            return np.concatenate([np.repeat(out[..., :1], 3, -1),
                                   out[..., 1:]], -1)
    return out


def decode_png_rgb(data: bytes, plain: bool = False) -> np.ndarray:
    """PNG bytes -> ``np.asarray(Image.open(...).convert("RGB"))``,
    (H, W, 3) uint8."""
    out, hd, palette = _decode(data, plain)
    if hd["colour"] == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[out[..., 0]]
    if hd["depth"] == 16:
        out = (np.minimum(out, 255) if hd["colour"] == 0 else out >> 8
               ).astype(np.uint8)
    if hd["colour"] in (0, 4):
        g = out[..., 0]
        if hd["colour"] == 0 and hd["depth"] < 8:
            g = g * np.uint8(255 // ((1 << hd["depth"]) - 1))
        return np.repeat(g[..., None], 3, axis=-1)
    return np.ascontiguousarray(out[..., :3])


def _read(path: str, rgb: bool) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png_rgb(data) if rgb else decode_png(data)
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
