"""Shared helpers of the port's parity tests (this file holds no tests).

The port (``drn_wsod_torch``) and the JAX package get the same inputs and
the same weights: weights are drawn with numpy under the flax parameter
names, handed to the JAX model as its ``params`` tree and to the port
through ``params_from_jax``.
"""

from __future__ import annotations

import pickle
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


VOC_OBJECT = """  <object><name>{name}</name>{difficult}<bndbox><xmin>{x1}</xmin>
  <ymin>{y1}</ymin><xmax>{x2}</xmax><ymax>{y2}</ymax></bndbox></object>
"""


def write_voc(root: Path, sizes, classes, split: str = "test", seed: int = 0,
              n_props: int = 40, xywh: bool = False, legacy: bool = False):
    """A VOC-layout directory under ``root`` with one JPEG per (h, w) of
    ``sizes`` (ids "000001", ...), XML annotations with 1-3 objects each
    (1-based pixel boxes, some difficult, some without a difficult tag, one
    of a class outside ``classes``; the last image has no XML), the split
    file, and a proposals pickle (``n_props`` boxes per image with some
    duplicates, objectness logits, XYXY or XYWH mode, the current or the
    legacy key names). Returns (VOC dir, proposal file, {id: image})."""
    from PIL import Image

    rs = np.random.RandomState(seed)
    d = root / "VOC2007"
    for sub in ("Annotations", "ImageSets/Main", "JPEGImages"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    ids, boxes, logits, images = [], [], [], {}
    for i, (h, w) in enumerate(sizes):
        fid = f"{i + 1:06d}"
        ids.append(fid)
        # smooth content: a JPEG of white noise is mostly ringing
        base = rs.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
        img = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR))
        Image.fromarray(img).save(d / "JPEGImages" / f"{fid}.jpg", quality=90)
        images[fid] = img
        if i < len(sizes) - 1:
            objs = ""
            for k in range(rs.randint(1, 4)):
                x1, y1 = rs.randint(1, w // 2), rs.randint(1, h // 2)
                x2 = rs.randint(x1 + 4, w + 1)
                y2 = rs.randint(y1 + 4, h + 1)
                diff = ("" if k == 2 else
                        f"<difficult>{int(rs.uniform() < 0.25)}</difficult>")
                objs += VOC_OBJECT.format(
                    name=classes[rs.randint(len(classes))], difficult=diff,
                    x1=x1, y1=y1, x2=x2, y2=y2)
            if i == 0:
                objs += VOC_OBJECT.format(name="unicorn", difficult="",
                                          x1=1, y1=1, x2=5, y2=5)
            (d / "Annotations" / f"{fid}.xml").write_text(
                f"<annotation><size><width>{w}</width><height>{h}</height>"
                f"<depth>3</depth></size>\n{objs}</annotation>\n")
        x1 = rs.randint(0, w - 8, n_props).astype(np.float32)
        y1 = rs.randint(0, h - 8, n_props).astype(np.float32)
        x2 = np.minimum(x1 + rs.randint(4, w, n_props), w - 1)
        y2 = np.minimum(y1 + rs.randint(4, h, n_props), h - 1)
        b = np.stack([x1, y1, x2, y2], 1).astype(np.float32)
        b[n_props // 2:n_props // 2 + 3] = b[:3]           # duplicates
        if xywh:
            b[:, 2:] -= b[:, :2]
        boxes.append(b)
        logits.append(np.round(rs.uniform(-2, 2, n_props), 1)
                      .astype(np.float32))                # ties
    (d / "ImageSets" / "Main" / f"{split}.txt").write_text(
        "\n".join(ids) + "\n")
    keys = ("indexes", "scores") if legacy else ("ids", "objectness_logits")
    props = {keys[0]: ids, "boxes": boxes, keys[1]: logits,
             "bbox_mode": 1 if xywh else 0}
    prop_file = root / f"props_{split}.pkl"
    with open(prop_file, "wb") as f:
        pickle.dump(props, f)
    return str(d), str(prop_file), images


def assert_detections_match(got: dict, want: dict, rtol: float, atol: float,
                            min_decided: int):
    """One image's detections (numpy, topk slots) against the JAX
    package's: valid slots equal, scores within tolerance, and class and box
    equal wherever a score is further from both neighbours than the
    tolerance (elsewhere the order of near-ties may differ). At least
    ``min_decided`` slots must be so decided."""
    np.testing.assert_array_equal(got["valid"], want["valid"])
    s = np.asarray(want["scores"])
    tol = atol * np.abs(s).max()
    np.testing.assert_allclose(got["scores"], s, rtol=rtol, atol=tol)
    gap = np.abs(np.diff(s)) > tol + rtol * np.abs(s[1:])
    lone = np.ones_like(s, bool)
    lone[1:] &= gap
    lone[:-1] &= gap
    assert lone.sum() >= min_decided
    np.testing.assert_array_equal(got["classes"][lone],
                                  np.asarray(want["classes"])[lone])
    boxes = np.asarray(want["boxes"])
    np.testing.assert_allclose(got["boxes"][lone], boxes[lone], rtol=rtol,
                               atol=atol * np.abs(boxes).max())


def d2_state_dict(port_sd: dict, module_prefix: bool = False) -> dict:
    """The port's state dict as a Detectron2 checkpoint holds it (numpy):
    the heads under ``roi_heads.``, fc1's input flattened as (C, 7, 7)."""
    heads = ("box_head.", "box_predictor.", "box_refinery.")
    out = {}
    for name, t in port_sd.items():
        v = np.asarray(t.detach().cpu().float().numpy())
        if name == "box_head.fc1.weight":             # (7, 7, C) -> (C, 7, 7)
            o, i = v.shape
            v = v.reshape(o, 7, 7, i // 49).transpose(0, 3, 1, 2).reshape(o, i)
        d2 = ("roi_heads." + name) if name.startswith(heads) else name
        out[("module." if module_prefix else "") + d2] = v
    return out
