"""Weight bridge from the JAX package's flax parameters to the port.

``params_from_jax`` takes the flax ``params`` tree flattened to dotted keys
(``backbone.res2_0.conv1.kernel``) and returns a state dict under the
port's Detectron2-style names (``backbone.res2.0.conv1.weight``): the
inverse of ``drn_wsod_tpu/checkpoint/torch_import.py:_d2_name_to_flax``
without its ``roi_heads.`` prefix. Conv kernels go from HWIO to OIHW, dense
kernels from (I, O) to (O, I); biases and FrozenBN's four vectors copy
unchanged. Both packages flatten the RoI features as (7, 7, C), so fc1 is
only transposed.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_PORT_NAME = re.compile(
    r"^(backbone\.stem\.conv\d"
    r"|backbone\.res\d\.\d+\.(conv\d|shortcut)"
    r"|box_head\.fc\d+"
    r"|box_predictor\.(cls|det)"
    r"|box_refinery\.\d+\.(cls_score|bbox_pred))"
    r"\.(weight|bias|norm\.(weight|bias|running_mean|running_var))$")


def port_name(flax_name: str) -> str:
    """Dotted flax param path -> the port's state-dict key."""
    n = re.sub(r"\b(res\d)_(\d+)\.", r"\1.\2.", flax_name)
    n = re.sub(r"\b(conv\d|shortcut)_norm\.", r"\1.norm.", n)
    n = re.sub(r"^box_refinery_(\d+)\.", r"box_refinery.\1.", n)
    return re.sub(r"\.kernel$", ".weight", n)


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened flax params -> the port's state dict (float32 tensors).

    Raises ``KeyError`` on a flax key that maps to no port tensor and on two
    keys that map to the same one. Load the result with
    ``model.load_state_dict(sd, strict=True)``, which raises on a tensor
    the model lacks or leaves unfilled.
    """
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        name = port_name(key)
        if not _PORT_NAME.match(name):
            raise KeyError(f"flax param {key!r} maps to no port tensor "
                           f"(got {name!r})")
        if name in out:
            raise KeyError(f"flax params map twice to {name!r}")
        v = np.array(value, dtype=np.float32)     # a writable copy
        if key.endswith(".kernel"):
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            elif v.ndim == 2:
                v = v.T                              # (I, O) -> (O, I)
            else:
                raise KeyError(f"kernel {key!r} has rank {v.ndim}")
        out[name] = torch.from_numpy(np.ascontiguousarray(v))
    return out
