"""Shared helpers of the port's parity tests (this file holds no tests).

The port (``drn_wsod_torch``) and the JAX package get the same inputs and
the same weights: weights are drawn with numpy under the flax parameter
names, handed to the JAX model as its ``params`` tree and to the port
through ``params_from_jax``.
"""

from __future__ import annotations

from pathlib import Path

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

import drn_wsod_torch
from drn_wsod_tpu.config import get_cfg as jax_get_cfg
from drn_wsod_tpu.structures import WSODBatch as JaxBatch

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
FLAGSHIP = str(CONFIGS / "PascalVOC-Detection" / "oicr_WSR_50_DC5_1x.yaml")

# the toy shape of __graft_entry__.dryrun_multichip: R18, DAN [64, 64], f32
TOY = ("MODEL.RESNETS.DEPTH", 18, "MODEL.RESNETS.RES2_OUT_CHANNELS", 64,
       "MODEL.ROI_BOX_HEAD.DAN_DIM", [64, 64],
       "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64, "MODEL.DTYPE", "float32")
# a narrow R50: bottleneck blocks (conv3 + shortcut) at small widths
NARROW_R50 = ("MODEL.RESNETS.DEPTH", 50, "MODEL.RESNETS.STEM_OUT_CHANNELS", 16,
              "MODEL.RESNETS.WIDTH_PER_GROUP", 8,
              "MODEL.RESNETS.RES2_OUT_CHANNELS", 32,
              "MODEL.ROI_BOX_HEAD.DAN_DIM", [64, 64],
              "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 64,
              "MODEL.DTYPE", "float32")


def cfg_pair(*overrides):
    """(JAX cfg, port cfg), both the flagship YAML with ``overrides``."""
    out = []
    for get_cfg in (jax_get_cfg, drn_wsod_torch.get_cfg):
        cfg = get_cfg()
        cfg.merge_from_file(FLAGSHIP)
        opts = []
        for k, v in zip(overrides[0::2], overrides[1::2]):
            opts += [k, repr(v) if not isinstance(v, str) else v]
        cfg.merge_from_list(opts)
        out.append(cfg)
    return tuple(out)


def jax_batch(batch: drn_wsod_torch.WSODBatch) -> JaxBatch:
    """The same batch as the JAX package's WSODBatch."""
    return JaxBatch(**{k: jnp.asarray(v.numpy())
                       for k, v in vars(batch).items()})


def flatten(tree) -> dict:
    return flax.traverse_util.flatten_dict(tree, sep=".")


def unflatten(flat: dict):
    return flax.traverse_util.unflatten_dict(
        {tuple(k.split(".")): jnp.asarray(v) for k, v in flat.items()})


def param_shapes(init_fn) -> dict:
    """{dotted flax name: shape} of ``init_fn()``'s params, traced only."""
    shapes = jax.eval_shape(init_fn)["params"]
    return {k: tuple(v.shape) for k, v in flatten(shapes).items()}


def random_params(shapes: dict, seed: int = 0) -> dict:
    """Numpy float32 weights under flax names: kernels N(0, 1/fan_in), so
    activations stay O(1) through a deep ReLU tower; FrozenBN statistics
    away from the identity; small random biases."""
    rng = np.random.RandomState(seed)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif leaf == "weight":                  # FrozenBN scale
            v = rng.uniform(0.3, 1.0, shape)
        elif leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, running_mean
            v = rng.randn(*shape) * 0.1
        out[name] = v.astype(np.float32)
    return out


def load_prefixed(module: torch.nn.Module, flat: dict, flax_prefix: str,
                  port_prefix: str) -> None:
    """Load a submodule's flax params through the bridge: the keys get a
    model-level prefix so that the bridge's names apply, and lose it after."""
    sd = drn_wsod_torch.params_from_jax(
        {flax_prefix + k: v for k, v in flat.items()})
    assert all(k.startswith(port_prefix) for k in sd), sorted(sd)[:3]
    module.load_state_dict({k[len(port_prefix):]: v for k, v in sd.items()},
                           strict=True)


def nhwc_to_port(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the NCHW channels_last tensor the port's tower takes."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def port_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()
