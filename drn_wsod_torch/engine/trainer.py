"""The train step and the host loop (counterpart of
``drn_wsod_tpu/engine/trainer.py``: ``TrainState``, ``create_train_state``,
``make_train_step``, ``make_multi_train_step`` and ``Trainer``).

PyTorch updates in place: the step changes the model's parameters, the
optimizer state and ``state.step``, and returns the same state. Metrics
stay on the device; nothing in a step waits on it (the step count, the
schedule and the dropout seed live on the host). ``Trainer`` reads them
back only where it writes them (every ``log_period`` iterations and at the
last), and those read-backs are its fences.

``make_csc_train_step`` is the step of the CSC heads (WSJDS included) while
their constraint is active: class-peak-gradient maps by gradients to the
image, center-surround weights, and the CSC-weighted image loss, with the
maps as WSJDS's seg targets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
import time
import weakref
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..models.heads.wsddn import image_probs
from ..ops import csc as csc_lib
from ..parallel import context
from ..solver.build import SGD
from ..structures.batch import WSODBatch
from ..utils import tracing
from .events import EventStorage
from .hooks import HookBase

logger = logging.getLogger(__name__)


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
        gen = step_generator(seed, state.step, batch.image.device)
        with tracing.span("train.forward"):
            losses = state.model(batch, train=True, generator=gen)
        return state, _apply_gradients(state, tx, losses, loss_weights)

    return train_step


def _apply_gradients(state: TrainState, tx: SGD, losses: dict,
                     loss_weights: Optional[Dict[str, float]]):
    """Weight the losses, take the gradients of their sum with respect to
    the trainable parameters, sum them over the data group where a mesh
    shard is active (``parallel/context.py``), and update; returns the
    detached losses and ``total_loss``."""
    params = {n: p for n, p in state.model.named_parameters()
              if p.requires_grad}
    if loss_weights:
        losses = {k: v * loss_weights.get(k, 1.0) for k, v in losses.items()}
    total = sum(losses[k] for k in sorted(losses))
    with tracing.span("train.backward"):
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
    with tracing.span("train.update"):
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        grads = context.reduce_gradients(grads)
        tx.update(grads, state.opt_state, params)
    state.step += 1
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["total_loss"] = total.detach()
    return metrics


def make_csc_train_step(model: nn.Module, tx: SGD,
                        loss_weights: Optional[Dict[str, float]] = None,
                        tau: float = 0.7, fg_threshold: float = 0.1,
                        context_scale: float = 1.8) -> Callable:
    """Build the train step of a CSC head while its constraint is active
    (the JAX package's ``make_csc_train_step``): the image as float32; the
    WSDDN proposal scores with dropout off and, from them, the image
    probabilities and the CPG maps (one backward pass to the image per
    class, zero below ``tau``); the center-surround weights (W, PL, NL) of
    each image, detached; then the losses with dropout, ``csc_w`` and the
    detached maps as ``cpg`` (WSJDS's seg targets), one update. The
    metrics add ``csc/W_pos_mean``, ``csc/W_neg_mean`` (the weights'
    positive and negative mass over present classes and proposals) and
    ``csc/pred_mean`` (the present classes' mean image probability)."""

    def train_step(state: TrainState, batch: WSODBatch, seed: int):
        image = batch.image.detach().float().requires_grad_(True)
        batch = batch.replace(image=image.detach())
        m = state.model
        gen = step_generator(seed, state.step, image.device)
        with torch.enable_grad():
            scores = m.proposal_scores(batch.replace(image=image))
        preds = image_probs(scores.detach())
        cpg = csc_lib.cpg_from_scores(scores, image, batch.labels, preds, tau)
        del scores
        W, PL, NL = csc_lib.csc_forward(
            cpg, batch.labels, preds, batch.proposals, batch.proposal_mask,
            fg_threshold=fg_threshold, context_scale=context_scale)
        # the maps also supervise the WSJDS seg branch (ignored elsewhere)
        losses = m(batch, train=True, generator=gen, csc_w=(W, PL, NL),
                   cpg=cpg.detach())
        metrics = _apply_gradients(state, tx, losses, loss_weights)
        present = batch.labels > 0.5
        w_present = torch.where(present[:, None, :], W, 0.0)
        n_present = context.global_sum(present.sum()).clamp(min=1)
        metrics["csc/W_pos_mean"] = (w_present.clamp(min=0).sum()
                                     / (n_present * W.shape[1]))
        metrics["csc/W_neg_mean"] = (-w_present.clamp(max=0)).sum() \
            / (n_present * W.shape[1])
        metrics["csc/pred_mean"] = torch.where(
            present, preds, 0.0).sum() / n_present
        return state, metrics

    return train_step


def make_multi_train_step(raw_step: Callable) -> Callable:
    """``multi_step(state, batches, seed)``: ``raw_step`` over a sequence
    of K batches back to back. Returns the state and the metrics stacked to
    (K,). The per-step dropout seed is the same as one step at a time, so
    the two agree exactly.

    The batches are not stacked: batches of different size buckets cannot
    be (the JAX package's chunked trainer stacks each chunk with
    ``np.stack``, which raises for them, so its multi-scale training runs
    one step a dispatch only)."""

    def multi_step(state: TrainState, batches: Sequence[WSODBatch],
                   seed: int):
        per_step = []
        for batch in batches:
            with tracing.span("train.step", id=state.step):
                state, metrics = raw_step(state, batch, seed)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    return multi_step


_STOP = object()      # end of a prefetch stream


class Trainer:
    """Hook-driven loop over a train step.

    ``step_fn(state, batch, seed) -> (state, metrics)`` runs one step;
    with ``multi_step_fn(state, batches, seed)`` (``make_multi_train_step``)
    and ``steps_per_dispatch`` K > 1 the loop pulls K batches at a time and
    runs them in one call, firing every before_step of the chunk before it
    and every after_step after it; a hook firing at an iteration inside a
    chunk sees the end-of-chunk state, so pick K dividing every hook period
    (``tools/train_net.py`` does). Hooks fire in the JAX package's order and
    at its iterations.

    Batches come from ``data_iter`` on the host (CPU tensors) and move to
    ``device`` (CUDA unless the caller names another one; raises where CUDA
    is absent). With ``prefetch_chunks`` > 0 a background thread pulls them
    ahead, pins each and copies it on a side CUDA stream; the loop's stream
    waits on the copy's event, and each copied tensor is recorded on the
    loop's stream, so that its memory is not reused while the step still
    reads it. With 0 the loop copies each batch itself when it needs it.

    ``train`` may be called more than once: the original iterator is kept,
    and each call wraps it in a prefetch stream of its own, bounded to that
    call's iterations. (The JAX package replaces its iterator with the first
    call's bounded prefetch stream, so a second call finds it exhausted.)

    Metrics stay on the device between read-backs (every ``log_period``
    iterations and at the last). Each read-back checks every pending value
    (the NaN guard raises ``FloatingPointError``), writes the latest step's
    values, ``data_time`` and ``lr`` to the storage, and fences the loop:
    ``last_chunk_step_time`` is the wall time between two fences over the
    steps between them (chunked: the chunk's time from its call to its
    read-back, over its steps)."""

    def __init__(self, step_fn: Callable, state, data_iter: Iterator,
                 seed: int = 0, lr_schedule: Optional[Callable] = None,
                 log_period: int = 20,
                 multi_step_fn: Optional[Callable] = None,
                 steps_per_dispatch: int = 1,
                 prefetch_chunks: int = 2, device=None):
        self._step_fn = step_fn
        self.state = state
        self._data_iter = data_iter
        self._seed = seed
        self._lr_schedule = lr_schedule
        self._log_period = log_period
        self._multi_step_fn = multi_step_fn
        self._steps_per_dispatch = max(int(steps_per_dispatch), 1)
        self._prefetch_chunks = max(int(prefetch_chunks), 0)
        self.device = resolve_device(device)
        self._hooks: List[HookBase] = []
        self._batches: Optional[Iterator] = None
        self.iter = 0
        self.start_iter = 0
        self.max_iter = 0
        self.storage: Optional[EventStorage] = None
        self.last_batch = None
        self.last_chunk_step_time = None   # set at fences
        self._last_fence_time = None
        self._last_fence_iter = None
        self._pending_metrics = None
        self._pending_data_time = 0.0

    def register_hooks(self, hooks: List[HookBase]):
        for h in hooks:
            h.trainer = weakref.proxy(self)
        self._hooks.extend(hooks)

    def train(self, start_iter: int, max_iter: int):
        self.iter = self.start_iter = start_iter
        self.max_iter = max_iter
        logger.info(f"Starting training from iteration {start_iter}")
        chunked = (self._multi_step_fn is not None
                   and self._steps_per_dispatch > 1)
        if not chunked:
            if self._prefetch_chunks > 0:
                self._batches = self._eager_prefetch_iter(
                    max_iter - start_iter)
            else:
                self._batches = self._inline_iter()
        with EventStorage(start_iter) as self.storage:
            try:
                for h in self._hooks:
                    h.before_train()
                if chunked:
                    self._run_chunked(start_iter, max_iter)
                else:
                    for self.iter in range(start_iter, max_iter):
                        for h in self._hooks:
                            h.before_step()
                        self.run_step()
                        for h in self._hooks:
                            h.after_step()
                        self.storage.step()
            finally:
                for h in self._hooks:
                    h.after_train()

    # ------------------------------------------------------------ data path
    def to_device(self, batch, stream=None):
        """A WSODBatch on the device (copied from pinned memory on
        ``stream`` where given); anything else is left as it is."""
        def copy(t: torch.Tensor) -> torch.Tensor:
            if stream is None:
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)

        return batch.map(copy) if isinstance(batch, WSODBatch) else batch

    def _copy_ahead(self, batches: list, stream):
        """Copy ``batches`` to the device on ``stream`` (CUDA) and return
        them with the event that marks the copies' end."""
        if stream is None:
            return [self.to_device(b) for b in batches], None
        with torch.cuda.stream(stream):
            out = [self.to_device(b, stream) for b in batches]
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _arrived(self, batches: list, event):
        """Make the loop's stream wait for a prefetched copy, and record
        every copied tensor on it."""
        if event is None:
            return
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for b in batches:
            if isinstance(b, WSODBatch):
                for t in b.tensors().values():
                    t.record_stream(current)

    def _side_stream(self):
        return (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                else None)

    def _next_host_batch(self):
        try:
            return next(self._data_iter)
        except StopIteration:
            raise RuntimeError("data iterator exhausted mid-training; train "
                               "loaders must be infinite (data/loader.py "
                               "TrainLoader)") from None

    def _inline_iter(self):
        while True:
            yield self.to_device(self._next_host_batch())

    def _prefetch(self, sizes: Sequence[int], depth: int):
        """A thread that pulls ``sizes[i]`` batches at a time, copies them
        ahead, and queues (batches, event); yields them on the loop's
        thread, each arrived on the loop's stream."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stream = self._side_stream()

        def worker():
            try:
                with (torch.cuda.device(self.device)
                      if self.device.type == "cuda"
                      else contextlib.nullcontext()):
                    for k in sizes:
                        with tracing.span("prefetch.pull"):
                            host = [self._next_host_batch() for _ in range(k)]
                        with tracing.span("prefetch.copy"):
                            batches, event = self._copy_ahead(host, stream)
                        q.put((batches, event))
                q.put(_STOP)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                q.put(e)

        threading.Thread(target=worker, daemon=True,
                         name="batch-prefetch").start()
        while True:
            item = q.get()
            if item is _STOP:
                return
            if isinstance(item, BaseException):
                raise item
            batches, event = item
            self._arrived(batches, event)
            yield batches

    def _eager_prefetch_iter(self, n: int):
        """One batch at a time, up to ``2 * prefetch_chunks`` ahead, at
        most ``n`` pulled (a finite iterator is not consumed past this
        call's horizon)."""
        for batches in self._prefetch([1] * n, 2 * self._prefetch_chunks):
            yield batches[0]

    # ------------------------------------------------------------- the loop
    def _waited(self, t0: int, steps: int) -> float:
        """Record the wait for batches since ``t0`` (perf_counter_ns) as
        the span ``train.data_wait``; returns its seconds a step, the
        ``data_time`` of each of the ``steps`` it fed."""
        t1 = time.perf_counter_ns()
        tracing.record("train.data_wait", t0, t1, id=self.state.step)
        return (t1 - t0) * 1e-9 / steps

    def run_step(self):
        t0 = time.perf_counter_ns()
        batch = next(self._batches)
        data_time = self._waited(t0, 1)

        with tracing.span("train.step", id=self.state.step):
            self.state, metrics = self._step_fn(self.state, batch,
                                                self._seed)
        self.last_batch = batch
        self._pending_metrics = metrics
        self._pending_data_time = data_time

        if (self.iter + 1) % self._log_period == 0 or \
                self.iter == self.max_iter - 1:
            self._flush_metrics()
            now = time.perf_counter()
            if self._last_fence_iter is not None:
                steps = self.iter - self._last_fence_iter
                if steps > 0:
                    self.last_chunk_step_time = \
                        (now - self._last_fence_time) / steps
            self._last_fence_time, self._last_fence_iter = now, self.iter

    def _chunk_iter(self, start_iter: int, max_iter: int):
        """Yield (chunk, k, per-step data_time): K batches at a time (the
        tail fewer), on the device."""
        K = self._steps_per_dispatch
        sizes = []
        it = start_iter
        while it < max_iter:
            sizes.append(min(K, max_iter - it))
            it += sizes[-1]
        if self._prefetch_chunks <= 0:
            for k in sizes:
                t0 = time.perf_counter_ns()
                chunk = [self.to_device(self._next_host_batch())
                         for _ in range(k)]
                yield chunk, k, self._waited(t0, k)
            return
        stream = self._prefetch(sizes, self._prefetch_chunks)
        while True:
            t0 = time.perf_counter_ns()
            chunk = next(stream, None)
            if chunk is None:
                return
            yield chunk, len(chunk), self._waited(t0, len(chunk))

    def _run_chunked(self, start_iter: int, max_iter: int):
        it = start_iter
        for chunk, k, data_time in self._chunk_iter(start_iter, max_iter):
            for j in range(k):
                self.iter = it + j
                for h in self._hooks:
                    h.before_step()
            self._pending_data_time = data_time
            t0 = time.perf_counter()
            with tracing.span("train.chunk", id=self.state.step):
                self.state, metrics = self._multi_step_fn(
                    self.state, chunk, self._seed)
            self.last_batch = chunk[-1]
            for j in range(k):
                self.iter = it + j
                if (self.iter + 1) % self._log_period == 0 or \
                        self.iter == max_iter - 1:
                    # check steps [0, j] of the chunk, record step j's
                    self._pending_metrics = {key: v[:j + 1]
                                             for key, v in metrics.items()}
                    self._flush_metrics()
                    self.last_chunk_step_time = \
                        (time.perf_counter() - t0) / k
                for h in self._hooks:
                    h.after_step()
                self.storage.step()
            it += k
        self.iter = max_iter - 1

    def _flush_metrics(self):
        """Read the pending metrics back in one copy, raise on any value
        that is not finite, and write the latest step's values, data_time
        and lr to the storage."""
        if self._pending_metrics is None:
            return
        names = list(self._pending_metrics)
        values = [torch.as_tensor(self._pending_metrics[k]).reshape(-1)
                  for k in names]
        sizes = [v.numel() for v in values]
        with tracing.span("train.flush", id=self.state.step):
            host = torch.cat([v.detach().double() for v in values]
                             ).cpu().numpy()
        per_name = dict(zip(names, np.split(host, np.cumsum(sizes)[:-1])))
        bad = {k: v.tolist() for k, v in per_name.items()
               if not np.isfinite(v).all()}
        if bad:
            raise FloatingPointError(
                f"Loss became non-finite at iteration {self.iter}: {bad}")
        self.storage.put_scalars(
            **{k: float(v[-1]) for k, v in per_name.items()},
            smoothing_hint=True)
        self.storage.put_scalar("data_time", self._pending_data_time,
                                smoothing_hint=True)
        if self._lr_schedule is not None:
            self.storage.put_scalar(
                "lr", float(self._lr_schedule(self.iter)),
                smoothing_hint=False)
