"""The weight bridge: every flax param of the JAX model maps to exactly one
tensor of the port's model, with the layout the port expects, and none is
left over on either side."""

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.checkpoint.from_jax import port_name
from drn_wsod_tpu.checkpoint.torch_import import _d2_name_to_flax
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (NARROW_R50, TOY, cfg_pair, jax_batch,
                               param_shapes, random_params)

torch.set_num_threads(1)

CONFIGS = {
    "r18_oicr": TOY,
    "narrow_r50_oicr": NARROW_R50,
    "r18_wsddn": TOY + ("MODEL.ROI_HEADS.NAME", "WSDDNROIHeads"),
    "r18_oicr_agnostic": TOY + ("MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG",
                                True),
}


def _flax_params(jax_cfg):
    jm = jax_build_model(jax_cfg)
    batch = drn_wsod_torch.synthetic_batch(1, 64, 64, 8, 20, device="cpu")
    key = jax.random.PRNGKey(0)
    return param_shapes(lambda: jm.init({"params": key, "dropout": key},
                                        jax_batch(batch), train=False))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_param_maps_once(name):
    jax_cfg, port_cfg = cfg_pair(*CONFIGS[name])
    shapes = _flax_params(jax_cfg)
    flat = random_params(shapes)
    sd = drn_wsod_torch.params_from_jax(flat)
    model = drn_wsod_torch.build_model(port_cfg, device="cpu")
    want = model.state_dict()
    assert len(sd) == len(flat)                 # one port tensor per param
    assert set(sd) == set(want)                 # none left over either side
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    model.load_state_dict(sd, strict=True)


def test_layouts_and_names():
    rng = np.random.RandomState(0)
    conv = rng.randn(3, 3, 4, 5).astype(np.float32)          # HWIO
    dense = rng.randn(6, 2).astype(np.float32)               # (I, O)
    sd = drn_wsod_torch.params_from_jax({
        "backbone.res3_1.conv2.kernel": conv,
        "backbone.res3_1.conv2_norm.running_var": np.ones(5, np.float32),
        "box_head.fc1.kernel": dense,
        "box_refinery_2.bbox_pred.bias": np.zeros(2, np.float32),
    })
    assert sorted(sd) == ["backbone.res3.1.conv2.norm.running_var",
                          "backbone.res3.1.conv2.weight",
                          "box_head.fc1.weight",
                          "box_refinery.2.bbox_pred.bias"]
    np.testing.assert_array_equal(sd["backbone.res3.1.conv2.weight"].numpy(),
                                  conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["box_head.fc1.weight"].numpy(), dense.T)


@pytest.mark.parametrize("d2_name", [
    "backbone.stem.conv1.weight", "backbone.stem.conv2.norm.running_mean",
    "backbone.res2.0.conv1.norm.weight", "backbone.res5.2.shortcut.weight",
    "backbone.res4.5.conv3.norm.bias", "roi_heads.box_head.fc2.bias",
    "roi_heads.box_predictor.det.weight",
    "roi_heads.box_refinery.1.cls_score.weight"])
def test_port_names_invert_the_d2_importer(d2_name):
    """port_name is the inverse of the JAX package's Detectron2 importer
    (without its roi_heads. prefix)."""
    assert port_name(_d2_name_to_flax(d2_name)) == \
        d2_name.replace("roi_heads.", "")


@pytest.mark.parametrize("key", [
    "backbone.res5_0.conv2_offset.kernel",      # deformable: not ported
    "backbone.res2_0.conv1_norm.scale",         # trainable BN leaf
    "seg_head.aspp.kernel"])
def test_unmapped_key_raises(key):
    with pytest.raises(KeyError):
        drn_wsod_torch.params_from_jax({key: np.zeros((3,), np.float32)})


def test_left_over_tensor_raises_on_load():
    jax_cfg, port_cfg = cfg_pair(*TOY)
    sd = drn_wsod_torch.params_from_jax(random_params(_flax_params(jax_cfg)))
    model = drn_wsod_torch.build_model(port_cfg, device="cpu")
    sd.pop("box_refinery.0.cls_score.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(sd, strict=True)
