"""Weight bridge from the JAX package's flax parameters to the port.

``params_from_jax`` takes the flax ``params`` tree flattened to dotted keys
(``backbone.res2_0.conv1.kernel``, ``backbone.plain1.conv1.bias``) and
returns a state dict under the port's Detectron2-style names
(``backbone.res2.0.conv1.weight``, ``backbone.plain1.0.conv1.bias``): the
inverse of ``drn_wsod_tpu/checkpoint/torch_import.py:_d2_name_to_flax``
without its ``roi_heads.`` prefix, plus the names that map cannot reach:
Cascade's ``cascade_head_{k}`` and ``cascade_predictor_{k}`` become
``box_head.{k}`` and ``box_predictor.{k}``, the FPN's ``fpn_lateral_res{n}``
and ``fpn_output_res{n}`` become ``fpn_lateral{n}`` and ``fpn_output{n}``,
a deformable block's ``conv2_deform_weight`` becomes ``conv2.weight``,
RetinaNet's ``head.cls_subnet_{i}`` (and ``bbox_subnet_{i}``) become
Detectron2's Sequential index ``head.cls_subnet.{2i}``, and the semantic
head's ``scale_head_{l}_conv{k}`` and ``scale_head_{l}_gn{k}`` become
``sem_seg_head.p{l + 2}.{2k}`` and its ``.norm`` (the head's levels taken
as p2, p3, ... in order, as every YAML names them), and the standalone
RPN head's ``conv``, ``objectness_logits`` and ``anchor_deltas`` become
``rpn_head.conv``, ``rpn_head.objectness_logits`` and
``rpn_head.anchor_deltas``.
Conv kernels (and ``conv2_deform_weight``, an HWIO kernel by another name)
go from HWIO to OIHW, dense kernels from (I, O) to (O, I); the transposed
convs of the mask and keypoint heads (``mask_head.deconv``,
``keypoint_head.score_lowres``: flax ``ConvTranspose`` kernels, (k, k, in,
out)) are flipped in both spatial axes and go to torch's (in, out, k, k),
which is what ``layers.ConvTranspose2d`` computes flax's result with; biases and
FrozenBN's four vectors copy unchanged. Both packages flatten the RoI features as (7, 7, C), so fc1 is
only transposed. Under ``NORM`` BN the flax BatchNorm's ``scale`` becomes
``norm.weight``, and its ``batch_stats`` (``mean``, ``var``, passed apart)
``norm.running_mean`` and ``norm.running_var``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

_PORT_NAME = re.compile(
    r"^(backbone\.(bottom_up\.)?stem\.conv\d"
    r"|backbone\.(bottom_up\.)?res\d\.\d+\.(conv\d|shortcut|conv2_offset)"
    r"|backbone\.plain\d\.0\.conv\d"
    r"|backbone\.fpn_(lateral|output)\d"
    r"|seg_head\.(aspp\.(conv1x1|conv3x3_d\d+|pool_conv|project)"
    r"|predictor)"
    r"|mask_head\.(mask_fcn\d+|deconv|predictor)"
    r"|keypoint_head\.(conv_fcn\d+|score_lowres)"
    r"|box_head\.(\d+\.)?fc\d+"
    r"|box_predictor\.(cls|det|cls_score|bbox_pred)"
    r"|head\.((cls|bbox)_subnet\.\d+|cls_score|bbox_pred)"
    r"|sem_seg_head\.(p\d\.\d+(\.norm)?|predictor)"
    r"|rpn_head\.(conv|objectness_logits|anchor_deltas)"
    r"|(box_predictor|box_refinery)\.\d+\.(cls_score|bbox_pred))"
    r"\.(weight|bias|norm\.(weight|bias|running_mean|running_var))$")


# flax ConvTranspose kernels (the mask and keypoint heads' upsampling)
_TRANSPOSED = ("mask_head.deconv.kernel", "keypoint_head.score_lowres.kernel")

# a flax BatchNorm's statistics (FrozenBN's are params named running_*)
_BN_STAT = re.compile(r"_norm\.(mean|var)$")


def port_name(flax_name: str) -> str:
    """Dotted flax param path -> the port's state-dict key."""
    n = re.sub(r"\b(res\d)_(\d+)\.", r"\1.\2.", flax_name)
    n = re.sub(r"\b(plain\d)\.", r"\1.0.", n)
    n = re.sub(r"\b(conv\d|shortcut)_norm\.", r"\1.norm.", n)
    n = re.sub(r"^box_refinery_(\d+)\.", r"box_refinery.\1.", n)
    n = re.sub(r"^cascade_head_(\d+)\.", r"box_head.\1.", n)
    n = re.sub(r"^cascade_predictor_(\d+)\.", r"box_predictor.\1.", n)
    n = re.sub(r"\.fpn_(lateral|output)_res(\d)\.", r".fpn_\1\2.", n)
    n = re.sub(r"^head\.(cls|bbox)_subnet_(\d+)\.",
               lambda m: f"head.{m[1]}_subnet.{2 * int(m[2])}.", n)
    n = re.sub(r"^sem_seg_head\.scale_head_(\d+)_(conv|gn)(\d+)\.",
               lambda m: f"sem_seg_head.p{int(m[1]) + 2}.{2 * int(m[3])}."
               + ("norm." if m[2] == "gn" else ""), n)
    n = re.sub(r"^(conv|objectness_logits|anchor_deltas)\.", r"rpn_head.\1.",
               n)
    n = re.sub(r"\.conv2_deform_weight$", ".conv2.weight", n)
    # flax BatchNorm, and the semantic head's GroupNorm
    n = re.sub(r"\.norm\.scale$", ".norm.weight", n)
    n = re.sub(r"\.norm\.(mean|var)$", r".norm.running_\1", n)
    return re.sub(r"\.kernel$", ".weight", n)


def params_from_jax(flat: Dict[str, np.ndarray],
                    batch_stats: Optional[Dict[str, np.ndarray]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flattened flax params (and, under ``NORM`` BN, the flattened
    ``batch_stats``) -> the port's state dict (float32 tensors).

    Raises ``KeyError`` on a flax key that maps to no port tensor (a
    BatchNorm statistic among the params, or anything but one among the
    ``batch_stats``) and on two keys that map to the same one. Load the
    result with
    ``model.load_state_dict(sd, strict=True)``, which raises on a tensor
    the model lacks or leaves unfilled.
    """
    out: Dict[str, torch.Tensor] = {}
    items = [(k, v, False) for k, v in flat.items()] + \
        [(k, v, True) for k, v in (batch_stats or {}).items()]
    for key, value, is_stat in items:
        name = port_name(key)
        if not _PORT_NAME.match(name) or \
                bool(_BN_STAT.search(key)) != is_stat:
            kind = "batch_stats" if is_stat else "param"
            raise KeyError(f"flax {kind} {key!r} maps to no port tensor "
                           f"(got {name!r})")
        if name in out:
            raise KeyError(f"flax params map twice to {name!r}")
        v = np.array(value, dtype=np.float32)     # a writable copy
        if key.endswith(_TRANSPOSED):
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)  # flipped HWIO -> IOHW
        elif key.endswith((".kernel", ".conv2_deform_weight")):
            if v.ndim == 4:
                v = v.transpose(3, 2, 0, 1)          # HWIO -> OIHW
            elif v.ndim == 2:
                v = v.T                              # (I, O) -> (O, I)
            else:
                raise KeyError(f"kernel {key!r} has rank {v.ndim}")
        out[name] = torch.from_numpy(np.ascontiguousarray(v))
    return out
