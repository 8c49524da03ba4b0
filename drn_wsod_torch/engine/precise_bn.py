"""PreciseBN: recompute BatchNorm statistics over training batches
(counterpart of ``drn_wsod_tpu/engine/precise_bn.py``).

The JAX package runs the model's train forward with its ``batch_stats``
mutable, recovers each batch's statistics from one EMA step, ``batch =
(new - 0.9 old) / (1 - 0.9)``, and installs their mean. Its detectors'
backbones always normalise with the running statistics and never write
them, so ``new`` is ``old`` and each run only rounds them: ``running_var``
1.0 becomes 1.0000002. This port does the same, in float32 and in the same
order, and runs the forward all the same (it is the hook's cost).
"""

from __future__ import annotations

import logging
from typing import Iterator

import torch
from torch import nn

from ..models.backbones.resnet_ws import BatchNorm

logger = logging.getLogger(__name__)

MOMENTUM = 0.9


def _stats(model: nn.Module) -> dict:
    """{name: buffer} of every BatchNorm statistic of ``model``."""
    return {f"{name}.{s}": getattr(m, s) for name, m in model.named_modules()
            if isinstance(m, BatchNorm)
            for s in ("running_mean", "running_var")}


def train_forward(model: nn.Module, batch) -> None:
    """The detector's train forward, dropout on with a generator seeded 0
    for every batch (the JAX hook's ``rngs={"dropout": PRNGKey(0)}``)."""
    gen = torch.Generator(device=batch.image.device).manual_seed(0)
    model(batch, train=True, generator=gen)


@torch.no_grad()
def update_bn_stats(model: nn.Module, batches: Iterator,
                    num_iters: int = 200) -> int:
    """Run :func:`train_forward` over at most ``num_iters`` of ``batches``
    and set each BatchNorm statistic of ``model`` to the mean over them of
    ``(new - 0.9 old) / (1 - 0.9)``, ``new`` read after the batch (and
    ``old`` restored before the next): summed from zeros, then divided by
    their count, each operation rounded to float32. Returns the number of
    batches (0, the model left as it is, where it has no BatchNorm)."""
    stats = _stats(model)
    if not stats:
        logger.info("update_bn_stats: the model has no BatchNorm; skipping")
        return 0
    old = {k: v.clone() for k, v in stats.items()}
    acc = {k: torch.zeros_like(v) for k, v in stats.items()}
    # the float32 values the JAX package's weakly typed scalars take
    m = {k: torch.full_like(v, MOMENTUM) for k, v in stats.items()}
    one_minus_m = {k: torch.full_like(v, 1.0 - MOMENTUM)
                   for k, v in stats.items()}
    n = 0
    for batch in batches:
        if n >= num_iters:
            break
        train_forward(model, batch)
        for k, new in _stats(model).items():
            acc[k] = acc[k] + (new - m[k] * old[k]) / one_minus_m[k]
            new.copy_(old[k])       # each batch starts from the old ones
        n += 1
    if n == 0:
        return 0
    for k, v in _stats(model).items():
        v.copy_(acc[k] / torch.full_like(v, float(n)))
    logger.info(f"update_bn_stats: recomputed over {n} batches")
    return n
