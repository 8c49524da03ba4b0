"""Model export through ``torch.export`` (counterpart of
``drn_wsod_tpu/export.py``, which serialises a ``jax.export`` StableHLO
program).

:func:`export_inference` traces a model's ``inference_scores`` (scores and
boxes, the inputs of NMS) at the example batch's shapes into an
``ExportedProgram`` and serialises it with ``torch.export.save``. The
program is shape-specialised, as the JAX package's is: export once per
padded serving bucket. The weights travel inside the artifact.

K1 is the op ``torch.ops.drn_wsod.roi_pool_batched`` (``ops/roi_pool.py``):
its fake implementation lets the trace pass through it, so the exported
program holds the op and, loaded on the card, launches the kernel.
:func:`load_exported` imports that module before it loads the artifact.

``WSODBatch`` crosses the calling convention as its eight input fields
(``INPUT_FIELDS``), positional tensors in that order; ``inference_scores``
reads no ground-truth field.

The models decorate ``inference_scores`` with ``torch.inference_mode()``;
inference tensors cannot be traced, so the export calls the undecorated
function (``__wrapped__``) under ``torch.no_grad()`` instead.
"""

from __future__ import annotations

import io
import logging
import os
from typing import Optional, Union

import torch

from .structures import WSODBatch

logger = logging.getLogger(__name__)

INPUT_FIELDS = ("image", "image_hw", "orig_hw", "proposals",
                "proposal_mask", "objectness", "labels", "image_id")


class _InferenceScores(torch.nn.Module):
    """``model.inference_scores`` as a module's forward over the batch's
    input fields."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model
        self._fn = type(model).inference_scores.__wrapped__

    def forward(self, *fields):
        return self._fn(self.model, WSODBatch(**dict(zip(INPUT_FIELDS,
                                                         fields))))


def _fields(batch: WSODBatch) -> tuple:
    return tuple(getattr(batch, f) for f in INPUT_FIELDS)


def export_inference(model: torch.nn.Module, batch: WSODBatch,
                     path: Optional[str] = None) -> bytes:
    """Export ``model.inference_scores`` at ``batch``'s shapes (the batch
    and the model on one device) and return the serialised program; write
    it to ``path`` too where given."""
    model.eval()
    with torch.no_grad():
        program = torch.export.export(_InferenceScores(model), _fields(batch),
                                      strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    data = buf.getvalue()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        logger.info(f"Exported inference program ({len(data)} bytes) "
                    f"to {path}")
    return data


class LoadedProgram:
    """A loaded ``ExportedProgram``: ``call(batch)`` runs it and returns
    ``(scores, boxes)``, as ``inference_scores`` does."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def call(self, batch: WSODBatch):
        with torch.no_grad():
            return self._module(*_fields(batch))


def load_exported(path_or_bytes: Union[str, bytes, bytearray]
                  ) -> LoadedProgram:
    """Load a program written by :func:`export_inference` from a path or
    its bytes."""
    from .ops import roi_pool  # noqa: F401  (registers the K1 op)

    src = (path_or_bytes if isinstance(path_or_bytes, str)
           else io.BytesIO(bytes(path_or_bytes)))
    return LoadedProgram(torch.export.load(src))


def holds_roi_pool(program) -> int:
    """How many calls of the K1 op the exported program's graph holds."""
    target = torch.ops.drn_wsod.roi_pool_batched.default
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and n.target is target)
