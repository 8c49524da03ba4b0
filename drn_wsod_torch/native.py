"""The port's host-side native code: the JPEG decoder (counterpart of
``drn_wsod_tpu/native.py``'s JPEG binding) and a JPEG encoder.

``ops/csrc/jpeg_decode.cpp`` is a decoder of its own, with no libjpeg. It
decodes every file that libjpeg-turbo (the JAX package's binding) or
Pillow decodes. Where libjpeg takes the file (Huffman or arithmetic
coded, baseline or progressive, whole or cut short, where libjpeg smooths
the blocks), it equals libjpeg-turbo's ISLOW, fancy-upsampled RGB decode
bit for bit, which is what Pillow returns and what the JAX package's
binding returns, at a DCT-domain prescale of ``scale_num``/8. Where only
Pillow takes it (CMYK and YCCK, lossless at 8 bits), it equals Pillow's
``convert("RGB")``, at ``scale_num`` 8 only, as Pillow decodes no other.
It builds with the host's C++ compiler at first use
(``ops/_build.py:build_host``); a missing compiler or a failed build
raises. ``jpeg_decode`` returns None for a file neither reference decodes
(see ``REASONS``), and :func:`jpeg_unsupported_reason` names why.
``jpeg_decode_status(..., native=True)`` returns Pillow's mode array
instead (L, RGB, or CMYK as ``np.asarray(Image.open(f))`` holds it).

``ops/csrc/jpeg_encode.cpp`` writes the bytes of Pillow's default
``Image.save`` of an RGB image (baseline, quality 75, 4:2:0, the standard
Huffman tables, a JFIF header), built the same way: :func:`jpeg_encode`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from .ops import _build

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_intp = ctypes.POINTER(ctypes.c_int)

# the decoder's status codes (jpeg_decode.cpp `Status`) -> the feature;
# neither libjpeg nor Pillow decodes these files
REASONS = {
    -1: "corrupt header",
    -2: "scale_num outside 1-8",
    -3: "output buffer too small",
    -5: "lossless in YCbCr or YCCK, or arithmetic lossless",
    -6: "12-bit",
    -8: "CMYK, YCCK or lossless file cut short",
    -9: "unsupported sampling factors",
    -10: "hierarchical",
    -11: "unsupported component count",
    -12: "CMYK, YCCK or lossless at scale_num below 8",
}


def _info_fn():
    return _build.bind_host("jpeg_decode", "jpeg_decode_info", _u8p,
                            ctypes.c_size_t, _intp, _intp)


def _decode_fn():
    return _build.bind_host("jpeg_decode", "jpeg_decode", _u8p,
                            ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                            _u8p, ctypes.c_size_t, _intp, _intp, _intp)


def jpeg_available() -> bool:
    """Whether the decoder builds and loads here."""
    try:
        _info_fn()
    except (RuntimeError, OSError):
        return False
    return True


def jpeg_decode_info(data: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the frame header, or None where none parses."""
    buf = np.frombuffer(data, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    if _info_fn()(buf, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        return None
    return w.value, h.value


def jpeg_decode_status(data: bytes, scale_num: int = 8, native: bool = False
                       ) -> Tuple[Optional[np.ndarray], int]:
    """(the decode or None, the decoder's status code: 0, or a key of
    ``REASONS``). The decode is (H, W, 3) RGB uint8, or with ``native``
    ``np.asarray(Image.open(f))``: (H, W) for a grayscale file, (H, W, 4)
    CMYK (a YCCK file converted, each value inverted as Pillow's "CMYK;I"
    mode reads it)."""
    if not 1 <= scale_num <= 8:
        return None, -2
    size = jpeg_decode_info(data)
    if size is None:
        return None, -1
    ow = -(-size[0] * scale_num // 8)
    oh = -(-size[1] * scale_num // 8)
    out = np.empty(oh * ow * 4, np.uint8)
    rw, rh, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    buf = np.frombuffer(data, np.uint8)
    rc = _decode_fn()(buf, len(data), scale_num, int(native), out,
                      out.nbytes, ctypes.byref(rw), ctypes.byref(rh),
                      ctypes.byref(ch))
    if rc != 0:
        return None, rc
    a = out[:oh * ow * ch.value].reshape(oh, ow, ch.value)
    return (a[..., 0] if ch.value == 1 else a).copy(), 0


def jpeg_decode(data: bytes, scale_num: int = 8) -> Optional[np.ndarray]:
    """Decode JPEG bytes -> (H, W, 3) RGB uint8, prescaled to
    ``scale_num``/8 of the native size in the DCT domain (each side
    ``ceil(side * scale_num / 8)``). None where the decoder does not take
    the file; :func:`jpeg_unsupported_reason` says why."""
    return jpeg_decode_status(data, scale_num)[0]


def jpeg_unsupported_reason(data: bytes) -> Optional[str]:
    """The feature behind a None from :func:`jpeg_decode` at ``scale_num``
    8 ("12-bit", "hierarchical", "corrupt header", ...), or None where the
    file decodes."""
    rc = jpeg_decode_status(data)[1]
    return REASONS.get(rc, f"status {rc}") if rc else None


def _encode_fn():
    return _build.bind_host("jpeg_encode", "jpeg_encode", _u8p, ctypes.c_int,
                            ctypes.c_int, _u8p, ctypes.c_size_t,
                            ctypes.POINTER(ctypes.c_size_t))


def jpeg_encode(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the JPEG bytes Pillow's default ``save``
    writes for it. Raises ``ValueError`` for another shape or dtype, or a
    side outside 1-65500."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"jpeg_encode takes (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w = rgb.shape[:2]
    rgb = np.ascontiguousarray(rgb)
    cap = 2 * rgb.nbytes + 4096
    out = np.empty(cap, np.uint8)
    n = ctypes.c_size_t()
    rc = _encode_fn()(rgb.reshape(-1), w, h, out, cap, ctypes.byref(n))
    if rc != 0:
        raise ValueError(f"jpeg_encode failed (status {rc}) for a "
                         f"{w}x{h} image")
    return out[:n.value].tobytes()
