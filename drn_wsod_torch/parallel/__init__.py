"""Several processes over ``torch.distributed`` (counterpart of
``drn_wsod_tpu/parallel``): the process-group helpers (``multihost``),
the step's view of the mesh that the losses read (``context``), the mesh
over the ranks and the DAN split (``mesh``) and the sharded steps
(``train_parallel``). Import ``mesh`` and ``train_parallel`` as modules:
the models import ``context``, and the steps import the models."""

from . import context, multihost

__all__ = ["context", "multihost"]
