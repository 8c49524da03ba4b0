"""Load Detectron2 (reference) weights into the port's model (counterpart of
``drn_wsod_tpu/checkpoint/torch_import.py:load_reference_weights``).

The port's ``state_dict`` already uses Detectron2's names and torch's
layouts, so a reference checkpoint loads by name once the ``module.`` and
``roi_heads.`` prefixes are stripped. One layout differs: the first DAN FC
consumes flattened RoI features, (C, 7, 7) in Detectron2 and (7, 7, C) in
both packages, so its input axis is permuted.

The transposed convs of the mask and keypoint heads (``mask_head.deconv``,
``keypoint_head.score_lowres``) load as the JAX package loads them: it
turns every 4-D weight from OIHW to HWIO, so a Detectron2
``ConvTranspose2d`` weight, (in, out, k, k), becomes a flax kernel
(k, k, out, in), unflipped. Where in == out (the mask head's 256 -> 256
deconv) that loads with the two axes swapped, and the port loads the
same kernel (bridged as ``checkpoint/from_jax.py`` bridges it); where they
differ (the keypoint head's 512 -> 17) both raise the shape
``ValueError``.

Where the JAX package's name map reaches no flax parameter, the port
loads nothing either, so that a checkpoint gives both the same model:
Cascade R-CNN's per-stage ``box_head.{k}`` and ``box_predictor.{k}`` (flax
``cascade_head_{k}``, ``cascade_predictor_{k}``), the FPN's
``fpn_lateral{n}`` and ``fpn_output{n}`` (flax ``fpn_lateral_res{n}``,
``fpn_output_res{n}``), a deformable block's ``conv2.weight`` (flax
``conv2_deform_weight``), RetinaNet's tower convs ``head.cls_subnet.{2i}``
and ``head.bbox_subnet.{2i}`` (flax ``head.cls_subnet_{i}``) and the
semantic head's scale heads ``sem_seg_head.p{n}.{2k}`` (flax
``scale_head_{l}_conv{k}`` and ``_gn{k}``) are reported unmatched in the
checkpoint and missing from the model, and keep their values. RetinaNet's
``head.cls_score`` and ``head.bbox_pred`` and the semantic head's
``predictor`` load in both.

Under ``NORM`` BN the import does what the JAX package's does: of each
BatchNorm only ``norm.bias`` loads. A Detectron2 ``norm.weight`` finds no
flax BatchNorm ``scale`` there, and its params hold no statistics, so
``norm.weight`` and the running statistics are reported unmatched, and
the model's ``norm.weight`` missing; the statistics keep their values.
"""

from __future__ import annotations

import logging
import pickle
import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.backbones.resnet_ws import BatchNorm, DeformConv2d

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


# state-dict keys the JAX package's Detectron2 name map cannot reach
_JAX_UNREACHED = re.compile(r"^(box_head|box_predictor)\.\d+\."
                            r"|^backbone\.fpn_(lateral|output)\d\."
                            r"|^head\.(cls|bbox)_subnet\."
                            r"|^sem_seg_head\.p\d\.")


_TRANSPOSED = ("mask_head.deconv.weight", "keypoint_head.score_lowres.weight")


def _convert(value: np.ndarray, target: torch.Tensor, key: str) -> np.ndarray:
    v = np.asarray(value)
    if key in _TRANSPOSED:
        # the flax kernel the JAX import makes, bridged as from_jax.py does
        flax = v.transpose(2, 3, 1, 0)
        i, o, kh, kw = target.shape
        if flax.shape != (kh, kw, i, o):
            raise ValueError(
                f"Shape mismatch for {key[:-len('weight')]}kernel: got "
                f"{flax.shape}, want {(kh, kw, i, o)}")
        return flax[::-1, ::-1].transpose(2, 3, 0, 1)
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
    bn = [n for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    stats = {f"{n}.{s}" for n in bn for s in ("running_mean", "running_var")}
    unloadable = stats | {f"{n}.weight" for n in bn} | {
        f"{n}.weight" for n, m in model.named_modules()
        if isinstance(m, DeformConv2d)} | {
        k for k in own if _JAX_UNREACHED.match(k)}
    converted = {}
    unmatched = []
    for name, val in state.items():
        if name.endswith("num_batches_tracked") or name.startswith("anchor"):
            continue
        key = _port_key(name)
        if key in own and key not in unloadable:
            converted[key] = _convert(val, own[key], key)
        else:
            unmatched.append(name)
    missing = [k for k in own if k not in converted and k not in stats]
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
