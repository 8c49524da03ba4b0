"""Synthetic batches (the port's own copy of
``__graft_entry__._synthetic_batch``): the same draws from the same seed,
so both packages see identical arrays."""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .structures.batch import WSODBatch


def synthetic_batch(B: int, H: int, W: int, P: int, C: int, seed: int = 0,
                    device=None) -> WSODBatch:
    """Random pixels, boxes inside the image, objectness in [0, 1) and a
    few positive labels, drawn with numpy from ``seed``; returned on
    ``device`` (CUDA unless the caller names another one)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(0, W * 0.6, (B, P)).astype(np.float32)
    y1 = rng.uniform(0, H * 0.6, (B, P)).astype(np.float32)
    bw = rng.uniform(8, W * 0.4, (B, P)).astype(np.float32)
    bh = rng.uniform(8, H * 0.4, (B, P)).astype(np.float32)
    proposals = np.stack([x1, y1, x1 + bw, y1 + bh], axis=-1)
    labels = np.zeros((B, C), dtype=np.float32)
    labels[:, rng.randint(0, C, size=max(2, C // 8))] = 1.0
    image = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    objectness = rng.uniform(0, 1, (B, P)).astype(np.float32)
    batch = WSODBatch(
        image=torch.from_numpy(image),
        image_hw=torch.full((B, 2), H, dtype=torch.int32),
        orig_hw=torch.full((B, 2), H, dtype=torch.int32),
        proposals=torch.from_numpy(proposals),
        proposal_mask=torch.ones((B, P), dtype=torch.bool),
        objectness=torch.from_numpy(objectness),
        labels=torch.from_numpy(labels),
        image_id=torch.arange(B, dtype=torch.int32),
    )
    return batch.to(dev)
