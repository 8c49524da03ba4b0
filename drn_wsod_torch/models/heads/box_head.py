"""DiscriminativeAdaptionNeck (DAN) box head (counterpart of
``drn_wsod_tpu/models/heads/box_head.py``).

``NUM_FC`` fully-connected layers, each followed by ReLU and dropout, over
(N, 7*7*C) pooled features. The input is flattened in (7, 7, C) order, as
in the JAX package; a Detectron2 checkpoint's fc1 is (C, 7, 7)-ordered and
needs its input axis permuted when it is loaded. The weights stay float32
and the products run in the model's dtype (:class:`..layers.Dense`).

Under a ``("data", "model")`` mesh the DAN is Megatron-split over the model
group (``parallel/mesh.py:shard_model`` slices the weights and sets
``split``): an odd fc is column-parallel (its input's gradient summed over
the group, its output a block of columns), an even fc row-parallel (the
partial products summed over the group, the bias added once after). An odd
fc without an even one after it has its columns gathered. Dropout draws
its masks at the full width and keeps the rank's columns, so the split
draws what one process draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel import context
from ..layers import Dense


def fast_dropout(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator],
                 cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Dropout with the masks drawn from ``generator`` (counterpart of
    ``FastDropout``): the identity when ``generator`` is None (eval) or the
    rate is 0; ``where(keep, x + x, 0)`` at rate 0.5, the DAN's rate;
    ``where(keep, x / (1 - rate), 0)`` otherwise. The masks differ from
    JAX's by construction (another generator). They are drawn at the
    global batch's rows and, with ``cols`` = (rank, size) of a
    column-split ``x``, at the full width (``parallel/context.py:
    draw_rows``)."""
    if generator is None or rate == 0.0:
        return x
    keep = context.draw_rows(
        lambda shape: torch.empty(shape, dtype=torch.bool,
                                  device=x.device).bernoulli_(
            1.0 - rate, generator=generator), x.shape, cols=cols)
    if rate == 0.5:
        return torch.where(keep, x + x, 0.0)
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _model_all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the model group, in float32 (gloo has no
    bfloat16 sum), back in its own dtype."""
    import torch.distributed as dist

    out = t.float().contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.dtype)


class _CopyToModelGroup(torch.autograd.Function):
    """The input of a column-parallel fc: the identity forward, its
    gradient summed over the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _model_all_reduce(grad, ctx.group), None


class _ReduceFromModelGroup(torch.autograd.Function):
    """The output of a row-parallel fc: the partial products summed over
    the model group forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _model_all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """A column block made whole: each rank's block at its place in zeros,
    summed over the model group; backward keeps the rank's block."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.width = rank, x.shape[-1]
        out = x.new_zeros(x.shape[:-1] + (x.shape[-1] * size,))
        out.narrow(-1, rank * x.shape[-1], x.shape[-1]).copy_(x)
        return _model_all_reduce(out, group)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(-1, ctx.rank * ctx.width, ctx.width)
                .contiguous(), None, None, None)


@dataclasses.dataclass(frozen=True)
class DanSplit:
    """The DAN's split over a model group: ``modes[i]`` is "col", "row"
    or None (replicated) for fc{i+1}."""

    group: Optional[object]
    rank: int
    size: int
    modes: Tuple[Optional[str], ...]


class DiscriminativeAdaptionNeck(nn.Module):
    def __init__(self, in_features: int, dan_dims: Sequence[int],
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_features, *dan_dims]
        self.num_fc = len(dan_dims)
        self.dropout = dropout
        for i in range(self.num_fc):
            self.add_module(f"fc{i + 1}", Dense(dims[i], dims[i + 1], dtype))
        self.split: Optional[DanSplit] = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dropout runs where a ``generator`` is given (training)."""
        x = x.reshape(x.shape[0], -1)
        sp = self.split
        for i in range(self.num_fc):
            fc = getattr(self, f"fc{i + 1}")
            mode = None if sp is None else sp.modes[i]
            if mode is None:
                x = fast_dropout(F.relu(fc(x)), self.dropout, generator)
            elif mode == "col":
                x = F.relu(fc(_CopyToModelGroup.apply(x, sp.group)))
                x = fast_dropout(x, self.dropout, generator,
                                 cols=(sp.rank, sp.size))
                if i + 1 == self.num_fc or sp.modes[i + 1] != "row":
                    x = _GatherColumns.apply(x, sp.group, sp.rank, sp.size)
            else:
                dt = fc.compute_dtype
                part = F.linear(x.to(dt), fc.weight.to(dt))
                x = _ReduceFromModelGroup.apply(part, sp.group) + \
                    fc.bias.to(dt)
                x = fast_dropout(F.relu(x), self.dropout, generator)
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """fc weights N(0, 0.005), bias 0.1 (reference DAN init)."""
        for i in range(self.num_fc):
            fc = getattr(self, f"fc{i + 1}")
            fc.weight.normal_(0.0, 0.005, generator=generator)
            fc.bias.fill_(0.1)
