"""The mesh over the ranks and the DAN split (counterpart of
``drn_wsod_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` of named axes, shards
the batch on ``data`` and, on a ``("data", "model")`` mesh, Megatron-splits
the DAN over ``model`` (``dan_tp_spec``). Here the ranks of the process
group take the devices' place, row-major over the mesh's shape as
``create_mesh`` reshapes its devices: on ``("data", "model") = (D, M)``,
rank ``d * M + m`` holds rows ``d`` of the global batch and DAN shard
``m``. Its data group is the ranks of its ``m``, its model group those of
its ``d``.

* :func:`shard_batch` is the rank's block of a global batch (the global
  batch is rank-major: rank 0's rows, then rank 1's), what the JAX
  package's ``shard_batch`` assembles from each process's local data;
* :func:`shard_state` slices the DAN's parameters and their optimizer
  state to the rank's shard by :func:`dan_tp_spec` (``state_shardings``);
  :func:`full_state_dict`, :func:`full_opt_state` and :func:`gathered`
  bring them back to full Detectron2 shapes, bit for bit;
  :func:`shard_state_dict` slices a full checkpoint for a split model.

Without a process group the mesh has one rank and no shard, and every
function here is the identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..structures.batch import WSODBatch
from . import multihost
from .context import StepShard

_DAN = re.compile(r"^box_head\.fc(\d+)\.(weight|bias)$")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks as a named grid: ``shape`` maps each axis to its size;
    ``shard`` is this rank's :class:`StepShard` (None without a process
    group)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    shard: Optional[StepShard]

    @property
    def data_rank(self) -> int:
        return 0 if self.shard is None else self.shard.data_rank

    @property
    def data_size(self) -> int:
        return 1 if self.shard is None else self.shard.data_size

    @property
    def model_rank(self) -> int:
        return 0 if self.shard is None else self.shard.model_rank

    @property
    def model_size(self) -> int:
        return 1 if self.shard is None else self.shard.model_size


def _fill_shape(axis_names, shape, n: int) -> List[int]:
    if shape is None:
        shape = [-1] + [1] * (len(axis_names) - 1)
    shape = [int(s) for s in shape]
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh axes {list(axis_names)} and shape {shape} "
                         "differ in length")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // known
    return shape


def create_mesh(axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None) -> Mesh:
    """The mesh of ``axis_names`` ("data" and, optionally, "model") over
    the ranks of the default process group (one rank without a group).
    A -1 in ``shape`` takes what the other axes leave, as in the JAX
    package, and a mesh needing more ranks than there are fails its
    assert. Unlike a JAX mesh, whose spare devices stay idle, it must
    cover every rank. Every rank calls this (groups are made
    collectively)."""
    axis_names = tuple(axis_names)
    if not set(axis_names) <= {"data", "model"} or \
            len(set(axis_names)) != len(axis_names):
        raise ValueError(f"mesh axes {axis_names}: only 'data' and 'model' "
                         "have a meaning here")
    n = multihost.get_world_size()
    shape = _fill_shape(axis_names, shape, n)
    total = int(np.prod(shape))
    assert total <= n, f"mesh {shape} needs {total} devices, have {n}"
    if total != n:
        raise ValueError(f"mesh {shape} covers {total} of {n} ranks")
    sizes = dict(zip(axis_names, shape))
    if not multihost.is_initialized():
        return Mesh(axis_names, sizes, None)
    import torch.distributed as dist

    grid = np.arange(n).reshape(shape)
    rank = multihost.get_rank()
    coord = dict(zip(axis_names, np.argwhere(grid == rank)[0]))
    groups = {}
    for axis in ("data", "model"):
        if axis not in axis_names:
            groups[axis] = None
            continue
        moved = np.moveaxis(grid, axis_names.index(axis), -1)
        for ranks in moved.reshape(-1, moved.shape[-1]).tolist():
            g = dist.new_group(ranks) if len(ranks) < n else dist.group.WORLD
            if rank in ranks:
                groups[axis] = g
    shard = StepShard(
        data_group=groups["data"], data_rank=int(coord.get("data", 0)),
        data_size=sizes.get("data", 1), model_group=groups["model"],
        model_rank=int(coord.get("model", 0)),
        model_size=sizes.get("model", 1))
    return Mesh(axis_names, sizes, shard)


# ----------------------------------------------------------------- batches
def shard_batch(batch: WSODBatch, mesh: Mesh) -> WSODBatch:
    """The rank's block of rows of a rank-major global batch (every
    tensor's leading axis); the batch itself for one data rank."""
    if mesh.data_size == 1:
        return batch
    n = batch.image.shape[0]
    if n % mesh.data_size:
        raise ValueError(f"global batch {n} not divisible by "
                         f"{mesh.data_size} data ranks")
    k = n // mesh.data_size
    return batch.map(lambda t: t[mesh.data_rank * k:(mesh.data_rank + 1) * k])


def stack_and_shard_batches(batches: Sequence[WSODBatch], mesh: Mesh
                            ) -> List[WSODBatch]:
    """The rank's blocks of K global batches: the input of
    ``make_sharded_multi_train_step`` (which takes a list, not a stack:
    batches of different buckets do not stack)."""
    return [shard_batch(b, mesh) for b in batches]


def rank_major(local_batches: Sequence[WSODBatch]) -> WSODBatch:
    """The global batch of the ranks' local batches, rank 0's rows first:
    the batch one process steps on to equal a step of the ranks."""
    names = local_batches[0].tensors().keys()
    return WSODBatch(**{k: torch.cat([b.tensors()[k] for b in local_batches])
                        for k in names})


# ---------------------------------------------------------------- DAN split
def dan_tp_spec(name: str, shape, axis_size: int) -> Optional[int]:
    """The dimension of a parameter split over a model axis of
    ``axis_size``, or None (replicated): the JAX rule on Detectron2 names.
    An odd ``box_head.fc{i}`` is column-parallel (the torch weight's
    (out, in) rows and the bias), an even one row-parallel (the weight's
    columns; the bias stays whole). A dimension that does not divide stays
    replicated, and so does every other parameter (Cascade's
    ``box_head.{k}.fc{i}`` among them)."""
    m = _DAN.match(name)
    if m is None or axis_size <= 1:
        return None
    idx, kind = int(m.group(1)), m.group(2)
    col = idx % 2 == 1
    if kind == "bias" and not col:
        return None
    dim = 0 if (col or kind == "bias") else 1
    return dim if shape[dim] % axis_size == 0 else None


def _dan(model: torch.nn.Module):
    from ..models.heads.box_head import DiscriminativeAdaptionNeck

    head = getattr(model, "box_head", None)
    return head if isinstance(head, DiscriminativeAdaptionNeck) else None


def split_dims(model: torch.nn.Module) -> Dict[str, int]:
    """{parameter name: split dimension} of a split model (empty
    otherwise)."""
    dan = _dan(model)
    if dan is None or dan.split is None:
        return {}
    return {n: p._split_dim for n, p in model.named_parameters()
            if getattr(p, "_split_dim", None) is not None}


def _block(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    k = t.shape[dim] // size
    return t.narrow(dim, rank * k, k).clone()


def shard_state(state, mesh: Mesh) -> bool:
    """Split the DAN of ``state.model`` over the mesh's model group in
    place: its parameters, their momentum traces (and ITER_SIZE
    accumulators) sliced to the rank's block and marked with
    ``_split_dim`` (the global-norm clip sums their squares over the
    group), the DAN told its layout. Returns whether anything was split."""
    from ..models.heads.box_head import DanSplit

    model = state.model
    dan = _dan(model)
    if mesh.model_size == 1 or dan is None or dan.split is not None:
        return False
    s = mesh.shard
    dims = {n: d for n, p in model.named_parameters()
            if (d := dan_tp_spec(n, p.shape, s.model_size)) is not None}
    if not dims:
        return False
    modes = tuple(
        {0: "col", 1: "row"}.get(dims.get(f"box_head.fc{i + 1}.weight"))
        for i in range(dan.num_fc))
    params = dict(model.named_parameters())
    with torch.no_grad():
        for n, d in dims.items():
            p = params[n]
            p.data = _block(p.data, d, s.model_rank, s.model_size)
            p._split_dim = d
            for key in ("trace", "acc"):
                buf = state.opt_state.get(key, {})
                if buf.get(n) is not None:
                    buf[n] = _block(buf[n], d, s.model_rank, s.model_size)
    dan.split = DanSplit(s.model_group, s.model_rank, s.model_size, modes)
    return True


def _exact_gather(t: torch.Tensor, dim: int, split) -> torch.Tensor:
    """The whole of a tensor split on ``dim`` over the split's group, bit
    for bit: each block's bits at its place in zeros, summed as integers
    (a float sum would turn -0.0 into 0.0)."""
    import torch.distributed as dist

    shape = list(t.shape)
    k = shape[dim]
    shape[dim] *= split.size
    ints = {4: torch.int32, 8: torch.int64}.get(t.element_size())
    bits = (t.contiguous().view(ints) if ints is not None
            else t.contiguous().view(torch.int16).to(torch.int32))
    out = bits.new_zeros(shape)
    out.narrow(dim, split.rank * k, k).copy_(bits)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=split.group)
    if ints is None:
        return out.to(torch.int16).view(t.dtype)
    return out.view(t.dtype)


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split parameter gathered to its
    full shape (every rank of the model group must call it)."""
    sd = model.state_dict()
    dims = split_dims(model)
    if dims:
        split = _dan(model).split
        for n, d in dims.items():
            sd[n] = _exact_gather(sd[n], d, split)
    return sd


def full_opt_state(model: torch.nn.Module, opt_state: dict) -> dict:
    """``opt_state`` with the split parameters' traces gathered (a new
    dict; the state itself is left as it is)."""
    dims = split_dims(model)
    if not dims:
        return opt_state
    split = _dan(model).split
    out = dict(opt_state)
    for key in ("trace", "acc"):
        if key in opt_state:
            out[key] = {n: (_exact_gather(v, dims[n], split)
                            if n in dims and v is not None else v)
                        for n, v in opt_state[key].items()}
    return out


def shard_state_dict(model: torch.nn.Module, sd: Dict[str, torch.Tensor],
                     opt_state: Optional[dict] = None):
    """A full checkpoint's ``sd`` (and ``opt_state``) sliced to the rank's
    blocks of a split model; as given where nothing is split."""
    dims = split_dims(model)
    if not dims:
        return sd, opt_state
    split = _dan(model).split
    sd = {n: (_block(v, dims[n], split.rank, split.size) if n in dims else v)
          for n, v in sd.items()}
    if opt_state is not None:
        opt_state = dict(opt_state)
        for key in ("trace", "acc"):
            if key in opt_state:
                opt_state[key] = {
                    n: (_block(v, dims[n], split.rank, split.size)
                        if n in dims and v is not None else v)
                    for n, v in opt_state[key].items()}
    return sd, opt_state


@contextlib.contextmanager
def gathered(model: torch.nn.Module):
    """The model with its DAN whole for the body (evaluation: each rank
    detects on its own images), split again after it. Collective over the
    model group; the identity for a model that is not split."""
    dims = split_dims(model)
    if not dims:
        yield model
        return
    dan = _dan(model)
    split = dan.split
    params = dict(model.named_parameters())
    blocks = {n: params[n].data for n in dims}
    with torch.no_grad():
        for n, d in dims.items():
            params[n].data = _exact_gather(blocks[n], d, split)
            params[n]._split_dim = None
    dan.split = None
    try:
        yield model
    finally:
        for n, d in dims.items():
            params[n].data = blocks[n]
            params[n]._split_dim = d
        dan.split = split


def broadcast_buffers(model: torch.nn.Module, src: int = 0) -> None:
    """Every buffer of ``model`` (the BatchNorm statistics) made rank
    ``src``'s, so that the replicas stay bit-equal after a hook that wrote
    them; a no-op for one rank."""
    if multihost.get_world_size() == 1:
        return
    import torch.distributed as dist

    for b in model.buffers():
        dist.broadcast(b, src=src)
