"""The train step (counterpart of ``drn_wsod_tpu/engine/trainer.py``:
``TrainState``, ``create_train_state``, ``make_train_step`` and
``make_multi_train_step``).

PyTorch updates in place: the step changes the model's parameters, the
optimizer state and ``state.step``, and returns the same state. Metrics
stay on the device; nothing in a step waits on it (the step count, the
schedule and the dropout seed live on the host). The host loop with hooks
and prefetch (``Trainer``) is a later slice (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..solver.build import SGD
from ..structures.batch import WSODBatch


@dataclasses.dataclass
class TrainState:
    step: int           # updates taken so far (micro-steps under ITER_SIZE)
    model: nn.Module    # holds the parameters
    opt_state: dict


def create_train_state(model: nn.Module, tx: SGD) -> TrainState:
    return TrainState(step=0, model=model,
                      opt_state=tx.init(dict(model.named_parameters())))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one step, seeded from (seed, step): the
    counterpart of ``fold_in(rng, state.step)``."""
    return torch.Generator(device=device).manual_seed(
        ((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF))


def make_train_step(model: nn.Module, tx: SGD,
                    loss_weights: Optional[Dict[str, float]] = None
                    ) -> Callable:
    """Build ``train_step(state, batch, seed) -> (state, metrics)``: the
    training losses (each scaled by ``loss_weights``, default 1), their sum
    ``total_loss``, gradients of the trainable parameters, one optimizer
    update. ``metrics`` holds every loss and the total, detached, on the
    device."""

    def train_step(state: TrainState, batch: WSODBatch, seed: int):
        params = {n: p for n, p in state.model.named_parameters()
                  if p.requires_grad}
        gen = step_generator(seed, state.step, batch.image.device)
        losses = state.model(batch, train=True, generator=gen)
        if loss_weights:
            losses = {k: v * loss_weights.get(k, 1.0)
                      for k, v in losses.items()}
        total = sum(losses[k] for k in sorted(losses))
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        tx.update(grads, state.opt_state, params)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return state, metrics

    return train_step


def make_multi_train_step(raw_step: Callable) -> Callable:
    """``multi_step(state, stacked_batch, seed)``: ``raw_step`` over each of
    the K batches stacked along a leading axis of every field, back to back.
    Returns the state and the metrics stacked to (K,). The per-step dropout
    seed is the same as one step at a time, so the two agree exactly."""

    def multi_step(state: TrainState, stacked_batch: WSODBatch, seed: int):
        fields = [f.name for f in dataclasses.fields(stacked_batch)]
        per_step = []
        for i in range(stacked_batch.image.shape[0]):
            batch = WSODBatch(**{f: getattr(stacked_batch, f)[i]
                                 for f in fields})
            state, metrics = raw_step(state, batch, seed)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    return multi_step
