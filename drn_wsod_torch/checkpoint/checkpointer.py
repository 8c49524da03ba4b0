"""Train-state checkpoints (counterpart of
``drn_wsod_tpu/checkpoint/checkpointer.py``): periodic saves of the train
state, the latest one found again, and resume-or-load.

A checkpoint is one ``torch.save`` file, ``model_{step:07d}.pth`` under the
directory, holding ``{"model": state_dict, "opt_state": ..., "step": n}``;
it is written to a temporary file and renamed into place, so a reader never
sees half a file. The JAX package saves through orbax; the port's files are
its own format and it does not read orbax checkpoints.

Over several processes every rank calls ``save`` (a split DAN is gathered
to its full Detectron2 shapes first, collectively), rank 0 alone writes,
and the others wait for it at a barrier; every rank reads on ``load``, and
a split model takes its blocks of the full tensors. So a checkpoint is the
same file whatever the mesh that wrote it, and loads on any other.
"""

from __future__ import annotations

import logging
import os
import re
from typing import List, Optional, Tuple

import torch

from ..parallel import mesh as mesh_lib
from ..parallel import multihost
from .torch_import import load_reference_weights

logger = logging.getLogger(__name__)

_NAME = re.compile(r"^model_(\d{7,})\.pth$")


def _load_into(template, saved):
    """``saved`` (from a checkpoint) copied into ``template``'s tensors in
    place, dict by dict; a value that is not a tensor is taken as saved."""
    if isinstance(template, torch.Tensor):
        if saved.shape != template.shape:
            raise ValueError(f"checkpoint tensor of shape {tuple(saved.shape)}"
                             f" for one of {tuple(template.shape)}")
        template.copy_(saved)
        return template
    if isinstance(template, dict):
        if set(template) != set(saved):
            raise KeyError(f"checkpoint keys {sorted(saved)[:5]} differ from "
                           f"the state's {sorted(template)[:5]}")
        for k in template:
            template[k] = _load_into(template[k], saved[k])
        return template
    return saved


class Checkpointer:
    """Saves into ``directory``, keeping the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self._dir, f"model_{step:07d}.pth")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self._dir))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step: int):
        """Write ``state`` (model parameters and buffers, optimizer state,
        ``state.step``) as the checkpoint of ``step``: on rank 0, the
        other ranks waiting (every rank calls this)."""
        model_sd = mesh_lib.full_state_dict(state.model)
        opt_state = mesh_lib.full_opt_state(state.model, state.opt_state)
        if multihost.is_main_process():
            path = self.path(step)
            tmp = f"{path}.tmp{os.getpid()}"
            torch.save({"model": model_sd, "opt_state": opt_state,
                        "step": int(state.step)}, tmp)
            os.replace(tmp, path)
            for old in self.all_steps()[:-self._max_to_keep]:
                os.remove(self.path(old))
            logger.info(f"Saved checkpoint at step {step} to {self._dir}")
        multihost.synchronize()

    def load(self, state, step: Optional[int] = None):
        """Copy the checkpoint of ``step`` (default: the latest) into
        ``state`` in place; returns the state."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint in {self._dir}")
        saved = torch.load(self.path(step), map_location="cpu",
                           weights_only=True)
        model_sd, opt_state = mesh_lib.shard_state_dict(
            state.model, saved["model"], saved["opt_state"])
        state.model.load_state_dict(model_sd, strict=True)
        state.opt_state = _load_into(state.opt_state, opt_state)
        state.step = int(saved["step"])
        logger.info(f"Restored checkpoint step {step} from {self._dir}")
        return state

    def resume_or_load(self, state, weights_path: str = "",
                       resume: bool = True) -> Tuple[object, int]:
        """Resume from the latest checkpoint where ``resume`` and one
        exists; otherwise load ``weights_path`` (Detectron2 weights,
        ``load_reference_weights``) into the model, where given.
        Returns (state, start_iter), ``start_iter`` being ``state.step``."""
        if resume and self.latest_step() is not None:
            state = self.load(state)
            return state, int(state.step)
        if weights_path:
            load_reference_weights(weights_path, state.model)
        return state, int(state.step)
