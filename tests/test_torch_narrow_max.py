"""K4, the narrow-dtype max (``drn_wsod_torch.ops.narrow_max``), and its
probe tool, against the JAX package's ``tools/mosaic_dtype_probe.py`` on
the CPU: the probe's inputs bit-equal to ``x.astype(dtype)`` in JAX for all
six dtypes, and the plain max bit-equal to ``jnp.maximum`` of the halves.

Two premises for random bit patterns, both about XLA on a CPU, not about the
function: XLA returns a NaN of its own (it canonicalizes the payload, and in
float8_e5m2 the sign) where the port returns the operand's NaN, so NaN
results compare as NaN; and XLA's CPU flushes bfloat16 subnormals to zero
(max(0x0024, 0x9c33) is 0x0000 there), so bfloat16 operands that are
subnormal are left out of the bit comparison."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from drn_wsod_torch.ops import narrow_max as nm
from drn_wsod_torch.tools import mosaic_dtype_probe

JAX_DTYPES = {"bfloat16": jnp.bfloat16, "int8": jnp.int8, "uint8": jnp.uint8,
              "float8_e4m3fn": jnp.float8_e4m3fn,
              "float8_e5m2": jnp.float8_e5m2, "int4": jnp.int4}


def _jax_probe_input(kind):
    """tools/mosaic_dtype_probe.py:24-25, verbatim."""
    x = jnp.arange(16 * 512, dtype=jnp.float32).reshape(16, 512)
    return (x / x.size).astype(JAX_DTYPES[kind])


def _values(t: torch.Tensor, kind):
    """A port tensor as a numpy array of the JAX dtype (int4 unpacked)."""
    if kind == "int4":
        return nm.unpack_int4(t).numpy()
    return t.view(torch.uint8).numpy().view(np.dtype(JAX_DTYPES[kind]))


def _jax_values(a, kind):
    a = np.asarray(a)
    return a.astype(np.int8) if kind == "int4" else a


@pytest.mark.parametrize("kind", nm.KINDS)
def test_probe_input_equals_jax_cast(kind):
    got = _values(nm.probe_input(kind), kind)
    want = _jax_values(_jax_probe_input(kind), kind)
    assert got.shape == (16, 512)
    assert got.tobytes() == want.tobytes()
    if kind in ("int8", "uint8", "int4"):
        assert not want.any()          # [0, 1) truncates to zero


@pytest.mark.parametrize("kind", nm.KINDS)
def test_plain_max_on_probe_input_equals_jnp_maximum(kind):
    x = _jax_probe_input(kind)
    want = _jax_values(jnp.maximum(x[0:8], x[8:16]), kind)
    got = _values(nm.narrow_max(nm.probe_input(kind), kind), kind)
    assert got.tobytes() == want.tobytes()


def _random_operands(kind, rng, shape=(16, 512)):
    """Random bit patterns of the dtype as (port tensor, JAX array)."""
    if kind == "int4":
        vals = rng.randint(-8, 8, shape).astype(np.int8)
        return nm.pack_int4(torch.from_numpy(vals)), \
            jnp.asarray(vals.astype(ml_dtypes.int4))
    dt = np.dtype(JAX_DTYPES[kind])
    raw = rng.randint(0, 256, (shape[0], shape[1] * dt.itemsize)).astype(
        np.uint8)
    raw[0, :2 * dt.itemsize] = [0x80] * dt.itemsize + [0] * dt.itemsize
    raw[8, :2 * dt.itemsize] = [0] * dt.itemsize + [0x80] * dt.itemsize
    return (torch.from_numpy(raw).view(nm.DTYPES[kind]),
            jnp.asarray(raw.view(dt)))


@pytest.mark.parametrize("kind", nm.KINDS)
def test_plain_max_on_random_bits_equals_jnp_maximum(kind):
    rng = np.random.RandomState(11 + nm.KINDS.index(kind))
    x, jx = _random_operands(kind, rng)
    got = _values(nm.narrow_max(x, kind), kind)
    want = _jax_values(jnp.maximum(jx[0:8], jx[8:16]), kind)
    if kind in ("int8", "uint8", "int4"):
        np.testing.assert_array_equal(got, want)
        return
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(np.isnan(got.astype(np.float32)), nan)
    keep = ~nan
    if kind == "bfloat16":
        ops = np.asarray(jx).astype(np.float32)
        tiny = float(ml_dtypes.finfo(ml_dtypes.bfloat16).smallest_normal)
        sub = (ops != 0) & (np.abs(ops) < tiny)
        keep &= ~(sub[0:8] | sub[8:16])
        assert keep.mean() > 0.9
    bits = np.uint16 if kind == "bfloat16" else np.uint8
    np.testing.assert_array_equal(got.view(bits)[keep], want.view(bits)[keep])
    # max(-0, +0) and max(+0, -0) are +0, as in jnp.maximum
    assert not got.view(bits)[0, :2].any()


@pytest.mark.parametrize("kind", ["bfloat16", "float8_e4m3fn", "float8_e5m2"])
def test_plain_max_returns_the_operands_nan(kind):
    """The port's NaN is an operand's: the first one where both are NaN."""
    bits = torch.int16 if kind == "bfloat16" else torch.uint8
    nan_a, nan_b, one = ((0x7fc1, 0xffc2, 0x3f80) if kind == "bfloat16"
                         else (0x7f, 0xff, 0x38) if kind == "float8_e4m3fn"
                         else (0x7e, 0xfd, 0x3c))
    a = torch.tensor([nan_a, one, nan_a], dtype=torch.int32)
    b = torch.tensor([nan_b, nan_b, one], dtype=torch.int32)
    x = torch.stack([a, b]).to(bits).view(nm.DTYPES[kind])
    got = nm.narrow_max(x, kind).view(bits).to(torch.int32) & \
        (0xFFFF if kind == "bfloat16" else 0xFF)
    assert got[0].tolist() == [nan_a, nan_b, nan_a]


def test_int4_packing_round_trip():
    vals = torch.arange(-8, 8, dtype=torch.int8).repeat(4, 2)
    packed = nm.pack_int4(vals)
    assert packed.dtype == torch.uint8 and packed.shape == (4, 16)
    assert packed[0, 0].item() == 0x98          # -8 low, -7 high
    assert torch.equal(nm.unpack_int4(packed), vals)
    with pytest.raises(ValueError):
        nm.pack_int4(torch.tensor([8, 0]))


def test_wrapper_checks_and_counts_no_cpu_launch():
    before = dict(nm.narrow_max.launches)
    for kind in nm.KINDS:
        nm.narrow_max(nm.probe_input(kind), kind)
    assert nm.narrow_max.launches == before and set(before.values()) == {0}
    with pytest.raises(TypeError):
        nm.narrow_max(nm.probe_input("int8"), "uint8")
    with pytest.raises(ValueError):
        nm.narrow_max(nm.probe_input("int8")[:15], "int8")
    with pytest.raises(ValueError):
        nm.narrow_max(nm.probe_input("int8"), "int2")


@pytest.mark.parametrize("kind", nm.KINDS)
def test_wrapper_checks_once_and_sends_cpu_tensors_plain(kind):
    """One pass of checks: a CPU tensor goes to the plain version, also at
    a size the kernel would refuse (halves of 3 elements); what no version
    takes (a 0-d or non-contiguous tensor) raises."""
    spec = nm._SPECS[kind]
    x = nm.probe_input(kind)
    assert nm._half_bytes(x, kind, spec) == 0
    small = x[:, :3].contiguous()
    assert nm._half_bytes(small, kind, spec) == 0
    assert torch.equal(nm.narrow_max(small, kind).view(torch.uint8),
                       nm.narrow_max_plain(small, kind).view(torch.uint8))
    for bad in (x.t(), x[0, 0]):
        with pytest.raises(ValueError):
            nm.narrow_max(bad, kind)


def test_dtype_probe_on_the_cpu_runs_every_dtype():
    lines = []
    rows = mosaic_dtype_probe.run(device="cpu",
                                  emit=lambda k, r: lines.append((k, r)))
    assert rows == lines == [(kind, "OK") for kind in nm.KINDS]


def test_dtype_probe_refuses_missing_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mosaic_dtype_probe.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        mosaic_dtype_probe.run()
