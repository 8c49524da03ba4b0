"""K3, the banded RoIPool (``roi_pool_banded``): its partition against the
JAX package's ``_pack_banded`` and its plain version against the JAX
package's exact RoIPool, on the CPU.

The partition: the short set and each short RoI's band start equal
``_pack_banded``'s ``is_s`` and band start. ``_pack_banded`` then packs the
short RoIs into runs padded to its RoI block (RB) and drops those whose slot
falls past P (``roi_pool_pallas.py:850``); the port has no slots and keeps
them. So it is compared at RB = 1, where no run is padded and nothing is
dropped, and at RB = 4 with the dropped RoIs computed from the port's own
runs. Pooling: exact, max |diff| == 0, compared by value (an empty bin may
be -0.0 on one side); the comparison with the Pallas kernel in interpret
mode is slow-marked, as the JAX package's own banded tests are."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.ops import roi_pool as port_pool
from drn_wsod_torch.tools.pool_banded_probe import boxes_voc_eval
from drn_wsod_tpu.ops.roi_align import roi_pool as jax_roi_pool
from drn_wsod_tpu.ops.roi_pool_pallas import _pack_banded, _xla_fallback
from test_torch_roi_pool import (CASES, DTYPES, _assert_equal_by_value,
                                 _inputs)

torch.set_num_threads(1)

_xla_fallback = jax.jit(_xla_fallback, static_argnums=(2, 3))
_pack_banded = jax.jit(_pack_banded, static_argnums=tuple(range(2, 11)))


def _mix(case, seed=3):
    """The box mixes of tests/test_roi_pool_pallas.py:221-294, at scale 1/4
    on a 48 x 40 map with 12-row bands (small_h 6): "mixed" (short boxes all
    over, tall ones, one off the map, one whole-image; B=2, P=16),
    "all_short" and "all_tall" (B=1, P=8)."""
    rng = np.random.RandomState(seed)
    H, W = 48, 40
    if case == "mixed":
        B, P = 2, 16
        feat = rng.randn(B, H, W, 16).astype(np.float32)
        boxes = np.zeros((B, P, 4), np.float32)
        for b in range(B):
            for p in range(P):
                if p < 9:
                    y1 = rng.uniform(-8, H * 4 - 8)
                    hgt = rng.uniform(4, 20)
                    x1 = rng.uniform(-8, W * 4 - 8)
                    wid = rng.uniform(4, 140)
                elif p < 14:
                    y1 = rng.uniform(-30, H * 2)
                    hgt = rng.uniform(60, H * 4)
                    x1 = rng.uniform(0, W * 2)
                    wid = rng.uniform(10, W * 4)
                elif p < 15:
                    y1, hgt, x1, wid = H * 4 + 50, 10, W * 4 + 50, 10
                else:
                    y1, hgt, x1, wid = 0, H * 4 - 1, 0, W * 4 - 1
                boxes[b, p] = (x1, y1, x1 + wid, y1 + hgt)
        scale = rng.uniform(1, 2, (B, P)).astype(np.float32)
        return feat, boxes, scale
    B, P = 1, 8
    feat = rng.randn(B, H, W, 8).astype(np.float32)
    if case == "all_short":
        y1 = rng.uniform(0, H * 4 - 20, (B, P))
        hgt = rng.uniform(4, 18, (B, P))
    else:
        y1 = rng.uniform(0, H, (B, P))
        hgt = rng.uniform(100, H * 4, (B, P))
    x1 = rng.uniform(0, W * 2, (B, P))
    wid = rng.uniform(8, W * 3, (B, P))
    boxes = np.stack([x1, y1, x1 + wid, y1 + hgt], -1).astype(np.float32)
    return feat, boxes, np.ones((B, P), np.float32)


MIXES = ["mixed", "all_short", "all_tall"]


def _probe_boxes(bucket):
    """The pool probe's boxes at one bucket: its RandomState(0) drawn over
    the buckets in order up to this one."""
    rs = np.random.RandomState(0)
    for S in (704, 1088, 1280, 1536):
        boxes = boxes_voc_eval(rs, 1, 4096, S)
        if S == bucket:
            return boxes


def _jax_partition(boxes, scale, H, W, small_h, band_rows, RB):
    """_pack_banded per image: (is_s (B, P), per-RoI band start (B, P))."""
    shorts, starts = [], []
    for bx in boxes:
        (_, bstart_s, _, slot_s, *_, is_s) = _pack_banded(
            jnp.asarray(bx), jnp.ones(bx.shape[:1], jnp.float32), scale, H,
            W, 7, RB, small_h, band_rows, 3, True)
        slot = np.asarray(slot_s)
        shorts.append(np.asarray(is_s))
        starts.append(np.asarray(bstart_s)[np.minimum(slot, len(slot) - 1)
                                           // RB])
    return np.stack(shorts), np.stack(starts)


def _port_partition(boxes, scale, H, small_h, band_rows):
    return port_pool.band_partition(torch.from_numpy(boxes), scale, H, 7,
                                    small_h, band_rows)


@pytest.mark.parametrize("case,bands",
                         [(m, (6, 12)) for m in MIXES]
                         + [("probe_704", (24, 48)),
                            ("probe_1536", (24, 48))])
def test_partition_matches_pack_banded(case, bands):
    """RB = 1: no padding, so the cap never drops a short RoI."""
    if case.startswith("probe_"):
        S = int(case.split("_")[1])
        boxes, scale, H, W = _probe_boxes(S), 0.125, S // 8, S // 8
    else:
        _, boxes, _ = _mix(case)
        scale, H, W = 0.25, 48, 40
    want_short, want_start = _jax_partition(boxes, scale, H, W, *bands, RB=1)
    part = _port_partition(boxes, scale, H, *bands)
    short = part.short.numpy()
    np.testing.assert_array_equal(short, want_short)
    np.testing.assert_array_equal(part.band_start.numpy()[short],
                                  want_start[short])
    if case == "all_tall":
        assert not short.any()
    if case == "all_short":
        assert short.all()


def test_partition_against_padded_runs():
    """At _pack_banded's RB = 4 its cap drops every short RoI whose padded
    slot falls past P: exactly those, found from the port's own runs (each
    band's run padded to a multiple of 4, laid end to end)."""
    _, boxes, _ = _mix("mixed")
    want_short, _ = _jax_partition(boxes, 0.25, 48, 40, 6, 12, RB=4)
    part = _port_partition(boxes, 0.25, 48, 6, 12)
    B, P = boxes.shape[:2]
    runs = part.run_start.numpy().astype(np.int64)
    order = part.order.numpy()
    kept = np.zeros((B, P), bool)
    dropped = 0
    for b in range(B):
        counts = np.diff(runs[b * part.num_bands:(b + 1) * part.num_bands
                              + 1])
        offsets = np.concatenate([[0], np.cumsum(-(-counts // 4) * 4)[:-1]])
        for k, (off, n) in enumerate(zip(offsets, counts)):
            first = runs[b * part.num_bands + k]
            for rank in range(n):
                p = order[first + rank] - b * P
                kept[b, p] = off + rank < P
                dropped += off + rank >= P
    assert dropped > 0, "the premise: the cap drops some short RoI here"
    np.testing.assert_array_equal(want_short, kept)
    np.testing.assert_array_equal(kept, part.short.numpy() & kept)


def test_runs_list_each_short_roi_once_by_band():
    _, boxes, _ = _mix("mixed")
    part = _port_partition(boxes, 0.25, 48, 6, 12)
    B, P = boxes.shape[:2]
    runs = part.run_start.numpy()
    order = part.order.numpy()
    assert runs[0] == 0 and runs[-1] == part.short.sum().item()
    seen = []
    for g in range(B * part.num_bands):
        b, k = divmod(g, part.num_bands)
        members = order[runs[g]:runs[g + 1]]
        assert (np.diff(members) > 0).all()               # RoI order
        for flat in members:
            assert flat // P == b
            assert part.short[b, flat % P] and part.band[b, flat % P] == k
        seen += members.tolist()
    assert sorted(seen) == sorted(np.flatnonzero(part.short.numpy()))
    assert sorted(order.tolist()) == list(range(B * P))


@pytest.mark.parametrize("bands", [(6, 12), (24, 48)], ids=["12row", "48row"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_xla_fallback(case, dtype, bands):
    """The geometry cases of test_torch_roi_pool (every Pallas tier,
    off-map, inverted, half-cell and random boxes) on 16 x 16 and 64 x 64
    maps: several bands at 12 rows, one band holding the whole map at 48."""
    tdt, jdt = DTYPES[dtype]
    feat, boxes, scale, roi_scale = _inputs(case, seed=70 + CASES.index(case))
    want = _xla_fallback(jnp.asarray(feat, jdt), jnp.asarray(boxes), scale,
                         7, jnp.asarray(roi_scale))
    args = (torch.from_numpy(feat).to(tdt), torch.from_numpy(boxes), scale, 7,
            torch.from_numpy(roi_scale))
    got = port_pool.roi_pool_banded_plain(*args, *bands)
    assert got.dtype == tdt
    _assert_equal_by_value(got, want)
    assert torch.equal(got, port_pool.roi_pool_plain(*args))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", MIXES)
def test_plain_matches_roi_pool_times_scale(case, dtype):
    """The banded mixes against ops/roi_align.py:roi_pool times the scale
    cast to the map's dtype, per image."""
    tdt, jdt = DTYPES[dtype]
    feat, boxes, scale = _mix(case)
    got = port_pool.roi_pool_banded_plain(
        torch.from_numpy(feat).to(tdt), torch.from_numpy(boxes), 0.25, 7,
        torch.from_numpy(scale), 6, 12)
    short = _port_partition(boxes, 0.25, 48, 6, 12).short
    assert short.any() == (case != "all_tall")
    for b in range(feat.shape[0]):
        want = jax_roi_pool(jnp.asarray(feat[b], jdt), jnp.asarray(boxes[b]),
                            0.25, resolution=7)
        want = want * jnp.asarray(scale[b]).astype(jdt)[:, None, None, None]
        _assert_equal_by_value(got[b], want)


def test_allow_banded_dispatch_and_no_launch_on_cpu():
    feat, boxes, scale = _mix("mixed")
    f, b, s = (torch.from_numpy(x) for x in (feat, boxes, scale))
    before = (port_pool.roi_pool_batched.launches,
              dict(port_pool.roi_pool_banded.launches))
    got = port_pool.roi_pool_batched(f, b, 0.25, 7, s, allow_banded=True)
    assert torch.equal(got, port_pool.roi_pool_banded(f, b, 0.25, 7, s))
    assert torch.equal(got, port_pool.roi_pool_batched(f, b, 0.25, 7, s))
    assert torch.equal(port_pool.roi_pool_banded(f, b, 0.25, 7),
                       port_pool.roi_pool_plain(f, b, 0.25, 7,
                                                torch.ones(2, 16)))
    assert (port_pool.roi_pool_batched.launches,
            port_pool.roi_pool_banded.launches) == before
    assert set(before[1].values()) == {0}


def test_band_tile_fits_shared_memory():
    """K3's channel tile at the probe's maps and the refusal of a band that
    cannot hold one 16-byte vector."""
    def tile(H, W, C, dtype=torch.bfloat16):
        return port_pool.band_tile(torch.empty(1, H, W, C, dtype=dtype))

    assert [tile(S // 8, S // 8, 2048) for S in (704, 1088, 1280, 1536)] \
        == [16, 16, 8, 8]
    assert tile(192, 192, 2048, torch.float32) == 4
    assert tile(13, 11, 32) == 32                       # whole C, small map
    for H, W in ((88, 88), (192, 192)):
        ct = tile(H, W, 2048)
        assert 48 * W * ct * 2 <= port_pool.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="shared memory"):
        tile(48, 400, 8)


def test_partition_refuses_empty_stride():
    with pytest.raises(ValueError):
        port_pool.band_partition(torch.zeros(1, 4, 4), 0.125, 64, 7, 24, 24)


@pytest.mark.slow
def test_plain_matches_pallas_banded_interpret():
    """Against roi_pool_pallas_banded itself in interpret mode, on the mixed
    box mix (about 40 s on a CPU, hence slow)."""
    from drn_wsod_tpu.ops.roi_pool_pallas import roi_pool_pallas_banded

    feat, boxes, scale = _mix("mixed")
    want = roi_pool_pallas_banded(
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(boxes), 0.25,
        resolution=7, roi_block=4, c_tile=8, interpret=True,
        roi_scale=jnp.asarray(scale), small_h=6, band_rows=12)
    got = port_pool.roi_pool_banded(
        torch.from_numpy(feat).to(torch.bfloat16), torch.from_numpy(boxes),
        0.25, 7, torch.from_numpy(scale), 6, 12)
    _assert_equal_by_value(got, want)

