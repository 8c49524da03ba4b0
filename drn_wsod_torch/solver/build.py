"""Optimizer and learning-rate schedule (counterpart of
``drn_wsod_tpu/solver/build.py``, which builds them on optax).

SGD with momentum in the reference's update order, as plain functions on
tensors so that each step is explicit:

  * coupled weight decay first (``g += wd * p``), then the momentum trace
    ``t = g + m * t`` (Nesterov: the update is ``g + m * t``), then
    ``p -= lr * update``;
  * two parameter groups: biases take ``BASE_LR * BIAS_LR_FACTOR`` and
    ``WEIGHT_DECAY_BIAS``; every other trainable parameter is a weight;
  * ``CLIP_GRADIENTS`` runs inside each group, so a global-norm clip takes
    the norm over the weight group and over the bias group separately (the
    JAX package clips inside each branch of ``optax.multi_transform``);
  * ``MOMENTUM_DTYPE bfloat16`` stores the trace in bfloat16: the update
    uses the float32 trace, and only the stored copy is cast (optax
    ``trace``); the stored trace is multiplied by the momentum rounded to
    bfloat16, as the JAX package computes it;
  * frozen parameters take no gradient (``requires_grad`` False) and have
    no optimizer state;
  * ``WSL.ITER_SIZE`` k > 1 averages the gradients of k micro-steps and
    updates on every k-th, with the schedule remapped to micro-steps
    (``optax.MultiSteps``).

The schedules return Python floats computed in float32, as the JAX
schedules compute them, from a step count kept on the host: nothing in a
step waits on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Union)

import numpy as np
import torch

_FROZEN_BN_LEAVES = ("running_mean", "running_var")
_F32 = np.float32


def warmup_factor_at(it: int, method: str, warmup_iters: int,
                     warmup_factor: float) -> np.float32:
    """Warmup factor at iteration ``it`` (Detectron2's
    ``_get_warmup_factor_at_iter``), in float32."""
    if warmup_iters <= 0:
        return _F32(1.0)
    x = _F32(it)
    if method == "constant":
        return _F32(warmup_factor) if x < warmup_iters else _F32(1.0)
    if method == "linear":
        alpha = min(x / _F32(warmup_iters), _F32(1.0))
        return (_F32(warmup_factor) * (_F32(1.0) - alpha) + alpha
                if x < warmup_iters else _F32(1.0))
    raise ValueError(f"Unknown warmup method: {method}")


def warmup_multistep_schedule(base_lr: float, steps: Sequence[int],
                              gamma: float, warmup_factor: float,
                              warmup_iters: int, warmup_method: str
                              ) -> Callable[[int], float]:
    def sched(count: int) -> float:
        w = warmup_factor_at(count, warmup_method, warmup_iters,
                             warmup_factor)
        mult = _F32(gamma) ** _F32(sum(count >= s for s in steps))
        return float(_F32(base_lr) * w * mult)

    return sched


def warmup_cosine_schedule(base_lr: float, max_iters: int,
                           warmup_factor: float, warmup_iters: int,
                           warmup_method: str) -> Callable[[int], float]:
    def sched(count: int) -> float:
        w = warmup_factor_at(count, warmup_method, warmup_iters,
                             warmup_factor)
        cos = _F32(0.5) * (_F32(1.0) + np.cos(
            _F32(math.pi) * _F32(count) / _F32(max_iters)))
        return float(_F32(base_lr) * w * cos)

    return sched


def build_lr_schedule(cfg) -> Callable[[int], float]:
    s = cfg.SOLVER
    if s.LR_SCHEDULER_NAME == "WarmupMultiStepLR":
        return warmup_multistep_schedule(
            s.BASE_LR, tuple(s.STEPS), s.GAMMA, s.WARMUP_FACTOR,
            s.WARMUP_ITERS, s.WARMUP_METHOD)
    if s.LR_SCHEDULER_NAME == "WarmupCosineLR":
        return warmup_cosine_schedule(
            s.BASE_LR, s.MAX_ITER, s.WARMUP_FACTOR, s.WARMUP_ITERS,
            s.WARMUP_METHOD)
    raise ValueError(f"Unknown LR scheduler: {s.LR_SCHEDULER_NAME}")


# ---------------------------------------------------------------------------
# Parameter partitioning
# ---------------------------------------------------------------------------

def _backbone_frozen_prefixes(freeze_at: int) -> tuple:
    """Name prefixes inside ``backbone.`` frozen at a given FREEZE_AT: 1
    freezes the stem, k >= 2 freezes res_k / plain_k too."""
    prefixes = []
    if freeze_at >= 1:
        prefixes += ["stem.", "plain1."]
    for k in range(2, freeze_at + 1):
        prefixes += [f"res{k}.", f"plain{k}."]
    return tuple(prefixes)


def make_param_labels(names: Iterable[str], freeze_at: int) -> Dict[str, str]:
    """Label each parameter 'frozen' | 'bias' | 'weight' by its port name
    (Detectron2 style, ``backbone.res2.0.conv1.weight``)."""
    frozen_prefixes = _backbone_frozen_prefixes(freeze_at)

    def label_for(name: str) -> str:
        keys = name.split(".")
        leaf = keys[-1]
        # FrozenBN: its statistics and affine are never trained
        if leaf in _FROZEN_BN_LEAVES:
            return "frozen"
        if any("_norm" in k or k == "norm" for k in keys[:-1]):
            return "frozen"
        if "backbone" in keys:
            rest = ".".join(keys[keys.index("backbone") + 1:])
            if rest.startswith(frozen_prefixes):
                return "frozen"
        return "bias" if leaf == "bias" else "weight"

    return {n: label_for(n) for n in names}


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

def clip_by_value(grads: List[torch.Tensor], value: float
                  ) -> List[torch.Tensor]:
    return [g.clamp(-value, value) for g in grads]


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> List[torch.Tensor]:
    """Scale the tensors by max_norm / norm where their joint L2 norm
    reaches max_norm (optax's select, on the device)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


@dataclasses.dataclass
class SGDGroup:
    """One parameter group's chain: clip, weight decay, momentum, lr."""

    lr: Callable[[int], float]
    weight_decay: float
    momentum: float
    nesterov: bool
    clip: Optional[Callable[[List[torch.Tensor]], List[torch.Tensor]]] = None
    momentum_dtype: Optional[torch.dtype] = None

    def init(self, p: torch.Tensor) -> Optional[torch.Tensor]:
        if not self.momentum:
            return None
        return torch.zeros_like(p, dtype=self.momentum_dtype or p.dtype)

    @torch.no_grad()
    def apply(self, params: List[torch.Tensor], grads: List[torch.Tensor],
              traces: List[Optional[torch.Tensor]], count: int) -> None:
        """Update ``params`` and ``traces`` in place with ``grads``."""
        if self.clip is not None:
            grads = self.clip(grads)
        if self.weight_decay:
            grads = [g + p * self.weight_decay
                     for g, p in zip(grads, params)]
        updates = grads
        if self.momentum:
            updates = []
            for g, t in zip(grads, traces):
                # JAX multiplies a bfloat16 trace by the momentum rounded
                # to bfloat16 (a weakly typed Python float), and XLA keeps
                # the product in float32: 0.8984375 * t for m = 0.9
                m = float(torch.tensor(self.momentum, dtype=t.dtype))
                new_t = g + t.float() * m
                updates.append(g + new_t * self.momentum if self.nesterov
                               else new_t)
                t.copy_(new_t)
        step = -self.lr(count)
        for p, u in zip(params, updates):
            p.add_(u * step)


class SGD:
    """The optimizer over a model's named parameters: ``init`` the state,
    then ``update`` parameters in place from gradients, both keyed by name.
    Frozen names are left out of the state and never touched."""

    def __init__(self, groups: Dict[str, SGDGroup], labels: Dict[str, str],
                 iter_size: int = 1):
        self.groups = groups
        self.labels = labels
        self.iter_size = iter_size

    def trainable(self, names: Iterable[str]) -> List[str]:
        return [n for n in names if self.labels[n] != "frozen"]

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        names = self.trainable(params)
        state = {"count": 0, "mini_step": 0,
                 "trace": {n: self.groups[self.labels[n]].init(params[n])
                           for n in names}}
        if self.iter_size > 1:
            state["acc"] = {n: torch.zeros_like(params[n]) for n in names}
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]) -> None:
        """One step: ``params`` (the trainable ones, by name) and ``state``
        change in place. With ITER_SIZE k, the gradients are averaged and
        the parameters move on every k-th call only."""
        names = self.trainable(params)
        if self.iter_size > 1:
            n = state["mini_step"]
            acc = state["acc"]
            for name in names:
                a = acc[name]
                a.copy_(a + (grads[name] - a) / (n + 1))
            state["mini_step"] = (n + 1) % self.iter_size
            if n != self.iter_size - 1:
                return
            grads = {name: acc[name].clone() for name in names}
            for name in names:
                acc[name].zero_()
        for label, group in self.groups.items():
            members = [n for n in names if self.labels[n] == label]
            if members:
                group.apply([params[n] for n in members],
                            [grads[n] for n in members],
                            [state["trace"][n] for n in members],
                            state["count"])
        state["count"] += 1


def build_optimizer(cfg, params: Union[torch.nn.Module,
                                       Mapping[str, torch.Tensor]]) -> SGD:
    """SGD with the reference's parameter groups over a model's named
    parameters (or a mapping of them). Parameters labelled frozen get
    ``requires_grad`` False."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    s = cfg.SOLVER
    sched = build_lr_schedule(cfg)
    k = int(cfg.WSL.ITER_SIZE)
    if k > 1:
        # the reference steps the lr every iteration and the optimizer every
        # k iterations, so the n-th update (0-based) uses the lr of
        # micro-iteration (n + 1) * k - 1
        iter_sched = sched
        sched = lambda n: iter_sched((n + 1) * k - 1)  # noqa: E731
    bias_factor = _F32(s.BIAS_LR_FACTOR)
    bias_sched = lambda n: float(_F32(sched(n)) * bias_factor)  # noqa: E731

    clip = None
    if s.CLIP_GRADIENTS.ENABLED:
        v = s.CLIP_GRADIENTS.CLIP_VALUE
        if s.CLIP_GRADIENTS.CLIP_TYPE == "value":
            clip = lambda g: clip_by_value(g, v)  # noqa: E731
        else:
            clip = lambda g: clip_by_global_norm(g, v)  # noqa: E731
    mom_dtype = {"": None, "float32": None,
                 "bfloat16": torch.bfloat16}[s.MOMENTUM_DTYPE]

    labels = make_param_labels(params, cfg.MODEL.BACKBONE.FREEZE_AT)
    for n, p in params.items():
        if labels[n] == "frozen":
            p.requires_grad_(False)
    groups = {
        "weight": SGDGroup(sched, s.WEIGHT_DECAY, s.MOMENTUM, s.NESTEROV,
                           clip, mom_dtype),
        "bias": SGDGroup(bias_sched, s.WEIGHT_DECAY_BIAS, s.MOMENTUM,
                         s.NESTEROV, clip, mom_dtype),
    }
    return SGD(groups, labels, k)
