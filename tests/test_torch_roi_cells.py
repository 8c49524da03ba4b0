"""``roi_cells``: the cells of each RoI clamped to the map, each counted
once, which K1's body reads once per channel vector. Held against a
brute-force count over a 0/1 mask of the cells the RoI's bins cover, against
``bin_cells`` (what a pool that reads every bin's cells separately reads),
and at the seeded inputs of the pool probe's four buckets and of
``chip_smoke.py`` phase 3."""

import numpy as np
import pytest
import torch

import chip_smoke
from drn_wsod_torch.ops import roi_pool as rp
from drn_wsod_torch.synthetic import synthetic_batch
from drn_wsod_torch.tools import pool_banded_probe as probe

torch.set_num_threads(1)


def _edge_boxes(rng, H, W, P=64):
    """Random boxes and the edge cases: off the map, inverted, sub-cell,
    the whole map and beyond, half cells (round half to even)."""
    x1 = rng.uniform(-60, W * 8 + 20, P)
    y1 = rng.uniform(-60, H * 8 + 20, P)
    bw = rng.uniform(-30, W * 6, P)
    bh = rng.uniform(-30, H * 6, P)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    boxes[0] = [-400, -400, -300, -300]                 # above-left
    boxes[1] = [W * 8 + 50, 0, W * 8 + 90, 40]          # right of the map
    boxes[2] = [-1000, -1000, 5000, 5000]               # whole map, beyond
    boxes[3] = [0, 0, W * 8 - 1, H * 8 - 1]             # the whole map
    boxes[4] = [40, 40, 41, 41]                         # sub-cell
    boxes[5] = [60, 60, 20, 10]                         # inverted
    boxes[6:14] = 8.0 * (rng.randint(-2, max(H, W) + 2, (8, 4)) + 0.5)
    return torch.from_numpy(boxes.astype(np.float32))


def _mask_count(box, H, W, R=7):
    """Cells any bin of the RoI covers, marked on a 0/1 mask."""
    x1, y1, rw, rh = rp.map_coords(box[None], 0.125)
    ylo, yhi = rp.bin_edges(y1, rh, H, R)
    xlo, xhi = rp.bin_edges(x1, rw, W, R)
    mask = np.zeros((H, W), np.int64)
    for ph in range(R):
        for pw in range(R):
            mask[ylo[0, ph]:yhi[0, ph], xlo[0, pw]:xhi[0, pw]] = 1
    return int(mask.sum())


@pytest.mark.parametrize("H,W,seed", [(13, 11, 0), (20, 31, 1), (3, 2, 2)])
def test_roi_cells_equals_a_mask_count(H, W, seed):
    boxes = _edge_boxes(np.random.RandomState(seed), H, W)
    got = rp.roi_cells(boxes, 0.125, H, W)
    assert got.dtype == torch.int64 and got.shape == boxes.shape[:1]
    assert got.tolist() == [_mask_count(b, H, W) for b in boxes]
    assert got[:3].tolist() == [0, 0, H * W] and got[3].item() == H * W


@pytest.mark.parametrize("H,W,seed", [(13, 11, 0), (87, 87, 3), (1, 5, 4)])
def test_roi_cells_at_most_bin_cells(H, W, seed):
    boxes = _edge_boxes(np.random.RandomState(seed), H, W, P=256)
    boxes = boxes.reshape(4, 64, 4)                     # any leading shape
    once = rp.roi_cells(boxes, 0.125, H, W)
    per_bin = rp.bin_cells(boxes, 0.125, H, W)
    assert once.shape == per_bin.shape == (4, 64)
    assert (once <= per_bin).all()
    # cells 0..14 by 0..7 (round half to even), clamped to the map
    assert rp.roi_cells(torch.tensor([[0.0, 0.0, 111.0, 55.0]]), 0.125, H,
                        W).item() == min(H, 8) * min(W, 15)


def _gb(cells):
    return round(cells.sum().item() * 2048 * 2 / 1e9, 2)


def test_cell_reads_at_the_probe_buckets_and_the_flagship():
    """Reads per call of a 2048-channel bf16 pool, once per cell against
    once per bin: the probe's four buckets (its boxes, drawn in order), the
    flagship synthetic boxes (B=2, 704 px, P=4096, seed 1) and those boxes
    with ``chip_smoke.py``'s edge cases mixed in, as phase 3 pools them."""
    rs = np.random.RandomState(0)
    got = []
    for S in probe.BUCKETS:
        boxes = torch.from_numpy(probe.boxes_voc_eval(rs, 1, 4096, S))
        got.append((_gb(rp.roi_cells(boxes, 0.125, S // 8, S // 8)),
                    _gb(rp.bin_cells(boxes, 0.125, S // 8, S // 8))))
    assert got == [(6.46, 10.26), (15.65, 21.38), (21.33, 27.74),
                   (30.10, 37.91)]
    synthetic = synthetic_batch(2, 704, 704, 4096, 20, seed=1,
                                device="cpu").proposals
    assert (_gb(rp.roi_cells(synthetic, 0.125, 87, 87)),
            _gb(rp.bin_cells(synthetic, 0.125, 87, 87))) == (12.23, 19.72)
    boxes, _ = chip_smoke.pool_boxes()
    assert (_gb(rp.roi_cells(boxes, 0.125, 87, 87)),
            _gb(rp.bin_cells(boxes, 0.125, 87, 87))) == (11.88, 19.2)


def test_top_row_order_sorts_each_image_by_its_top_edge():
    boxes = _edge_boxes(np.random.RandomState(5), 13, 11, P=128).reshape(
        2, 64, 4)
    order = rp.top_row_order(boxes)
    assert order.dtype == torch.int32 and order.shape == (2, 64)
    for b in range(2):
        assert sorted(order[b].tolist()) == list(range(64))
        y1 = boxes[b, order[b].long(), 1]
        assert (y1[1:] >= y1[:-1]).all()
