"""Load Detectron2 (reference) weights into the port's model (counterpart of
``drn_wsod_tpu/checkpoint/torch_import.py:load_reference_weights``).

The port's ``state_dict`` already uses Detectron2's names and torch's
layouts, so a reference checkpoint loads by name once the ``module.`` and
``roi_heads.`` prefixes are stripped. One layout differs: the first DAN FC
consumes flattened RoI features, (C, 7, 7) in Detectron2 and (7, 7, C) in
both packages, so its input axis is permuted.
"""

from __future__ import annotations

import logging
import pickle
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The arrays of a ``.pkl`` (with or without a "model" key) or a
    ``.pth``/``.pt`` checkpoint (under "model" or "state_dict", or bare).
    Both formats are pickles and are trusted: load only files from a known
    source."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        if "model" in data:
            data = data["model"]
        return {k: np.asarray(v) for k, v in data.items()
                if isinstance(v, np.ndarray) or hasattr(v, "__array__")}
    data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, dict) and "model" in data:
        data = data["model"]
    if isinstance(data, dict) and "state_dict" in data:
        data = data["state_dict"]
    return {k: v.numpy() for k, v in data.items() if hasattr(v, "numpy")}


def _port_key(name: str) -> str:
    """A Detectron2 checkpoint name -> the port's state-dict key."""
    return re.sub(r"^roi_heads\.", "", re.sub(r"^module\.", "", name))


def _convert(value: np.ndarray, target: torch.Tensor, key: str) -> np.ndarray:
    v = np.asarray(value)
    if key == "box_head.fc1.weight" and v.ndim == 2 and \
            target.shape[1] == v.shape[1] and v.shape[1] % 49 == 0:
        # flattened RoI input: (O, C*7*7) -> (O, 7*7*C)
        o, i = v.shape
        v = v.reshape(o, i // 49, 7, 7).transpose(0, 2, 3, 1).reshape(o, i)
    if v.shape != tuple(target.shape):
        raise ValueError(f"Shape mismatch for {key}: got {v.shape}, want "
                         f"{tuple(target.shape)}")
    return v


def load_reference_weights(path: str, model: torch.nn.Module
                           ) -> Tuple[List[str], List[str]]:
    """Load the checkpoint at ``path`` into ``model`` in place, by name,
    each tensor cast to the dtype and device of the one it replaces.

    Returns (unmatched, missing): the checkpoint's names that match no
    tensor of the model, and the model's keys the checkpoint does not
    fill (they keep their values); both are logged. Raises ``ValueError``
    on a shape that does not match."""
    state = _load_state_dict(path)
    own = model.state_dict()
    converted = {}
    unmatched = []
    for name, val in state.items():
        if name.endswith("num_batches_tracked") or name.startswith("anchor"):
            continue
        key = _port_key(name)
        if key in own:
            converted[key] = _convert(val, own[key], key)
        else:
            unmatched.append(name)
    missing = [k for k in own if k not in converted]
    if unmatched:
        logger.warning(
            f"{len(unmatched)} checkpoint params unmatched, e.g. "
            f"{unmatched[:5]}")
    if missing:
        logger.warning(
            f"{len(missing)} model params not in checkpoint (kept init), "
            f"e.g. {missing[:5]}")
    with torch.no_grad():
        for key, v in converted.items():
            own[key].copy_(torch.from_numpy(np.array(v)))
    return unmatched, missing
