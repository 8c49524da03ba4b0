"""The sharded step's view of the mesh, read by the losses, the random draws
and the gradient update.

The JAX package jits its step over the global batch, and GSPMD makes every
loss a loss of the global batch: a mean over images divides by the global
batch size, a count in a denominator counts over every image, and the
gradients are summed over the ``data`` axis. Here each process runs the
step on its own rows of the global batch, so the step does that by hand
while a :class:`StepShard` is active (``parallel/train_parallel.py``
activates it around each step):

* :func:`global_sum` sums a count (no gradient) over the data group, so
  that ``local sum / global count`` summed over the ranks is the global
  loss; :func:`mean` and :func:`batch_size` are the same for a mean over
  the batch axis and for the batch size, local batches being equal;
* :func:`draw_rows` draws a random tensor at the global batch's shape from
  the step's generator and keeps this rank's rows (and, under the DAN
  split, its columns), so that every rank draws what one process draws on
  the rank-major global batch;
* :func:`reduce_gradients` sums the gradients over the data group in one
  coalesced ``all_reduce`` a dtype, and :func:`reduce_metrics` the detached
  losses.

Without an active shard every helper is the identity and nothing is
communicated, so a step of one process runs exactly as it always did. The
only collectives are ``all_reduce`` (sum) and ``broadcast``, which both the
NCCL and the gloo backend run on CUDA tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StepShard:
    """This rank's place in the mesh: its data group (the ranks that hold
    the other rows of the global batch) and its model group (the ranks that
    hold the other DAN shards). A group of None is the default group."""

    data_group: Optional[object]
    data_rank: int
    data_size: int
    model_group: Optional[object] = None
    model_rank: int = 0
    model_size: int = 1


_ACTIVE: Optional[StepShard] = None


@contextlib.contextmanager
def sharded(shard: Optional[StepShard]):
    """Make ``shard`` the active one for the body (None: no shard)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, shard
    try:
        yield shard
    finally:
        _ACTIVE = prev


def active() -> Optional[StepShard]:
    return _ACTIVE


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a count or sum in a normaliser, no gradient) summed over the
    data group; ``t`` itself without an active shard."""
    s = _ACTIVE
    if s is None:
        return t
    return _all_reduce(t.detach().clone(), s.data_group)


def mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` (its leading axis the batch's) over the global
    batch, as this rank's share: the local mean over the number of data
    ranks (local batches are equal)."""
    s = _ACTIVE
    return x.mean() if s is None else x.mean() / s.data_size


def batch_size(n: int) -> int:
    """The global batch size of a local batch of ``n``."""
    s = _ACTIVE
    return n if s is None else n * s.data_size


def draw_rows(draw, shape: Sequence[int], dim: int = 0,
              cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``draw(global_shape)`` with ``shape[dim]`` scaled to the global
    batch, then this rank's block of rows along ``dim``; with ``cols`` =
    (rank, size) also the rank's block of the last axis, drawn at ``size``
    times its width. Without a shard and ``cols``, ``draw(shape)``."""
    s = _ACTIVE
    rows = 1 if s is None else s.data_size
    full = list(shape)
    full[dim] *= rows
    if cols is not None:
        full[-1] *= cols[1]
    out = draw(tuple(full))
    if rows > 1:
        n = shape[dim]
        out = out.narrow(dim, s.data_rank * n, n)
    if cols is not None and cols[1] > 1:
        w = shape[-1]
        out = out.narrow(-1, cols[0] * w, w)
    return out


def _coalesced_all_reduce(tensors: List[torch.Tensor], group) -> List:
    """Sum ``tensors`` over ``group`` in one ``all_reduce`` a dtype and
    device; returns new tensors, the inputs untouched."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    buckets: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _all_reduce(flat, group)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def reduce_gradients(grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """The gradients summed over the data group (DDP's reduction, which
    ``torch.autograd.grad`` would never trigger); ``grads`` without a
    shard."""
    s = _ACTIVE
    if s is None or not grads:
        return grads
    names = list(grads)
    return dict(zip(names, _coalesced_all_reduce(
        [grads[n] for n in names], s.data_group)))


def reduce_metrics(metrics: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The detached metrics (each rank's share of a global loss) summed
    over the data group; ``metrics`` without a shard."""
    s = _ACTIVE
    if s is None or not metrics:
        return metrics
    names = list(metrics)
    vals = [torch.as_tensor(metrics[n]).detach().float() for n in names]
    return dict(zip(names, _coalesced_all_reduce(vals, s.data_group)))


def model_sum_sq(parts: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
    """The sum of squares of DAN shards over the model group (a global
    gradient norm under the split); None for no parts."""
    if not parts:
        return None
    sq = sum((g * g).sum() for g in parts)
    s = _ACTIVE
    if s is None or s.model_size == 1:
        return sq
    return _all_reduce(sq.clone(), s.model_group)
