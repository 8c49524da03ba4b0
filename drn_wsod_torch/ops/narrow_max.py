"""Elementwise max of the two halves of a narrow-dtype array (K4): the plain
PyTorch version and the CUDA kernel's wrapper.

``narrow_max(x, kind)`` takes a (2h, ...) array and returns the (h, ...)
max of ``x[:h]`` and ``x[h:]``, as the JAX package's
``tools/mosaic_dtype_probe.py:probe`` did in Pallas for a (16, 512) input.
Kinds: bfloat16, int8, uint8, float8_e4m3fn, float8_e5m2 (torch dtypes of
those names) and int4, stored two to a byte in a uint8 tensor (element 2j in
the low nibble, 2j + 1 in the high one; :func:`pack_int4`).

Semantics, in both versions: floats compare by value; a NaN operand wins
(the first if both are), as ``jnp.maximum`` propagates NaN; of two equal
values the result is their bitwise AND, so max(-0, +0) is +0 in either
order, as ``jnp.maximum`` gives it. Integers compare signed (int8, int4) or
unsigned (uint8). The result is always an operand's bits or their AND: no
value is rounded. (XLA canonicalizes the NaN it returns, by backend; the
port returns the operand's NaN.)

CPU tensors go through :func:`narrow_max_plain` (``torch.maximum`` has no
CPU kernel for float8 and torch has no int4); CUDA tensors launch
``csrc/narrow_max.cu`` and add one to ``narrow_max.launches[kind]``. A
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KINDS = ("bfloat16", "int8", "uint8", "float8_e4m3fn", "float8_e5m2", "int4")
DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8,
          "uint8": torch.uint8, "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2, "int4": torch.uint8}
# the integer type of each float kind's bits
_BITS = {"bfloat16": torch.int16, "float8_e4m3fn": torch.uint8,
         "float8_e5m2": torch.uint8}


def pack_int4(values: torch.Tensor) -> torch.Tensor:
    """(..., 2n) integers in [-8, 7] -> (..., n) uint8, two to a byte,
    element 2j in the low nibble."""
    if values.shape[-1] % 2:
        raise ValueError(f"int4 packs pairs: the last axis must be even, got "
                         f"{tuple(values.shape)}")
    v = values.to(torch.int16)
    if v.numel() and (v.min() < -8 or v.max() > 7):
        raise ValueError("int4 holds -8..7")
    nib = v & 0xF
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., n) uint8 -> (..., 2n) int8, each nibble sign-extended."""
    p = packed.to(torch.int16)
    lo, hi = p & 0xF, p >> 4
    both = torch.stack([lo, hi], -1).flatten(-2)
    return (both - ((both & 0x8) << 1)).to(torch.int8)


def probe_input(kind: str, device=None) -> torch.Tensor:
    """The JAX probe's input in ``kind``: ``arange(16 * 512) / 8192`` as a
    (16, 512) float32 array, cast (truncated toward zero for the integer
    kinds, so all zeros there). int4 comes packed, (16, 256) uint8."""
    x = torch.arange(16 * 512, dtype=torch.float32,
                     device=device).reshape(16, 512) / (16 * 512)
    if kind == "int4":
        return pack_int4(x.to(torch.int8))
    return x.to(DTYPES[kind])


def narrow_max_plain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The plain version of K4: the max of ``x[:h]`` and ``x[h:]``."""
    h = x.shape[0] // 2
    a, b = x[:h], x[h:]
    if kind == "int4":
        return pack_int4(torch.maximum(unpack_int4(a), unpack_int4(b)))
    if kind not in _BITS:
        return torch.maximum(a, b)
    fa, fb = a.float(), b.float()
    ia, ib = a.view(_BITS[kind]), b.view(_BITS[kind])
    take_b = (fb.isnan() & ~fa.isnan()) | (fb > fa)
    bits = torch.where(fa == fb, ia & ib, torch.where(take_b, ib, ia))
    return bits.view(x.dtype)


# kind -> (its torch dtype, the kernel's kind code)
_SPECS = {kind: (DTYPES[kind], code) for code, kind in enumerate(KINDS)}


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.bind("narrow_max", "drn_narrow_max", ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p)


def _half_bytes(x: torch.Tensor, kind: str, spec) -> int:
    """Every check of :func:`narrow_max`, each made once: the bytes of a
    half of ``x`` where the kernel takes it (a contiguous CUDA tensor of
    the kind's dtype, an even first axis, a half of whole 16-byte vectors,
    16-byte aligned); 0 for a CPU tensor, which the plain version takes;
    raises on anything else."""
    if spec is None:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if x.dtype is not spec[0]:
        raise TypeError(f"{kind} data must be {spec[0]}, got {x.dtype}")
    if not x.dim() or x.shape[0] & 1 or not x.is_contiguous():
        raise ValueError(f"need a contiguous tensor with an even first axis, "
                         f"got {tuple(x.shape)}")
    if not x.is_cuda:
        return 0
    half_bytes = x.nbytes >> 1
    if not half_bytes or (half_bytes | x.data_ptr()) & 15:
        raise ValueError(f"the kernel moves 16-byte vectors: a half of "
                         f"{half_bytes} bytes must be a positive multiple "
                         f"of 16 and 16-byte aligned")
    return half_bytes


def narrow_max(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The max of the two halves of a contiguous (2h, ...) tensor of
    ``kind`` (int4: packed uint8). CPU tensors take the plain version; CUDA
    tensors launch the kernel, which moves 16-byte vectors: a half must be a
    whole number of them, 16-byte aligned.

    The kernel's time is its launch, so the host path is short: one pass
    of checks (:func:`_half_bytes`), one allocation, and a C entry point
    and a stream getter bound once."""
    spec = _SPECS.get(kind)
    half_bytes = _half_bytes(x, kind, spec)
    if not half_bytes:
        return narrow_max_plain(x, kind)
    out = x.new_empty((x.shape[0] >> 1, *x.shape[1:]))
    err = _kernel()(x.data_ptr(), out.data_ptr(), half_bytes, spec[1],
                    _build.raw_stream(x.get_device()))
    if err != 0:
        raise RuntimeError(f"narrow_max kernel launch failed ({kind}): "
                           f"CUDA error {err}")
    narrow_max.launches[kind] += 1
    return out


narrow_max.launches = {kind: 0 for kind in KINDS}
