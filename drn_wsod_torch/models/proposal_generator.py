"""Anchor generation (counterpart of
``drn_wsod_tpu/models/proposal_generator.py:generate_anchors``; the RPN
and RRPN functions of that module are ROADMAP.md queue 1, item 15c).

A level's anchors are a fixed grid: the cell anchors of every (size,
aspect ratio) pair, centred on each feature cell's centre.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def generate_anchors(feature_hw: Tuple[int, int], stride: int,
                     sizes: Sequence[float], aspect_ratios: Sequence[float],
                     device=None) -> torch.Tensor:
    """Dense anchor grid of one level -> (Hf * Wf * A, 4) float32 XYXY, the
    A = len(sizes) * len(aspect_ratios) anchors of a cell innermost (size
    major, ratio minor).

    As the JAX function computes them: each cell anchor's width
    ``(size**2 / ratio) ** 0.5`` and height ``ratio * width`` in Python
    doubles, rounded to float32 once; the cell centres
    ``(arange + 0.5) * stride`` in float32 (an offset of 0.5, where
    Detectron2's default is 0); centre plus cell anchor in float32."""
    cell = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = (area / ar) ** 0.5
            h = ar * w
            cell.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    cell_anchors = torch.tensor(cell, dtype=torch.float32, device=device)

    Hf, Wf = feature_hw
    shifts_x = (torch.arange(Wf, dtype=torch.float32, device=device)
                + 0.5) * stride
    shifts_y = (torch.arange(Hf, dtype=torch.float32, device=device)
                + 0.5) * stride
    sy, sx = torch.meshgrid(shifts_y, shifts_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 1, 4)
    return (shifts + cell_anchors[None]).reshape(-1, 4)
