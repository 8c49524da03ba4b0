"""The sharded train and inference steps (counterpart of
``drn_wsod_tpu/parallel/train_parallel.py``).

Each rank steps on its block of the global batch with the mesh's shard
active (``parallel/context.py``): every loss divides by its global
normaliser, every random draw is the global batch's, the gradients are
summed over the data group in one coalesced ``all_reduce`` after
``torch.autograd.grad`` (``engine/trainer.py:_apply_gradients``; DDP's
reducer fires on ``.backward()`` only), and the metrics returned are the
global losses, summed over the data group. So a step of the ranks is a
step of one process on the rank-major global batch, up to the order of
float sums, as GSPMD makes the JAX package's sharded step a step of one
device. On a mesh with a ``model`` axis over 1 the DAN is split over it
first (``mesh.shard_state``), which needs the state.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..engine import trainer as trainer_lib
from . import context
from .mesh import Mesh, shard_state


def _split(mesh: Mesh, state) -> None:
    if mesh.model_size > 1:
        if state is None:
            raise ValueError("the DAN split needs the train state, to "
                             "split its parameters and their optimizer "
                             "state")
        shard_state(state, mesh)


def _in_mesh(step: Callable, mesh: Mesh) -> Callable:
    def sharded_step(state, batch, seed):
        with context.sharded(mesh.shard):
            state, metrics = step(state, batch, seed)
            return state, context.reduce_metrics(metrics)

    return sharded_step


def make_sharded_train_step(model, tx, mesh: Mesh, loss_weights=None,
                            state=None) -> Callable:
    """``make_train_step`` over the mesh: the rank steps on its block of
    the global batch; with a ``model`` axis over 1, pass ``state`` (split
    in place)."""
    _split(mesh, state)
    return _in_mesh(trainer_lib.make_train_step(model, tx, loss_weights),
                    mesh)


def make_sharded_multi_train_step(model, tx, mesh: Mesh, loss_weights=None,
                                  state=None) -> Callable:
    """K steps a call (``make_multi_train_step``) of the sharded step, over
    the rank's blocks of K global batches
    (``mesh.stack_and_shard_batches``)."""
    _split(mesh, state)
    return trainer_lib.make_multi_train_step(
        make_sharded_train_step(model, tx, mesh, loss_weights))


def make_sharded_csc_train_step(model, tx, mesh: Mesh, loss_weights=None,
                                state=None, **csc_kwargs) -> Callable:
    """The CSC step over the mesh: the CPG pass is per image, so it needs
    nothing of the other ranks; the CSC losses and metrics are global."""
    _split(mesh, state)
    return _in_mesh(trainer_lib.make_csc_train_step(
        model, tx, loss_weights, **csc_kwargs), mesh)


def make_sharded_inference_fn(model, mesh: Optional[Mesh] = None
                              ) -> Callable:
    """``infer(batch) -> (scores, boxes)``: ``inference_scores`` of the
    rank's images (each rank of a model group given the same ones under
    the split)."""
    shard = None if mesh is None else mesh.shard

    def infer(batch):
        with context.sharded(shard):
            return model.inference_scores(batch)

    return infer
