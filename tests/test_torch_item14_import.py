"""Weights of the supervised, FPN and deformable models: the bridge from
flax names (``params_from_jax``) and the Detectron2 import
(``checkpoint/torch_import.py``) against the JAX package's, on the CPU.

The bridge's names: ``box_predictor.cls_score``, ``cascade_head_{k}`` to
``box_head.{k}``, ``cascade_predictor_{k}`` to ``box_predictor.{k}``,
``backbone.bottom_up.*``, ``fpn_lateral_res{n}`` to ``fpn_lateral{n}``,
``fpn_output_res{n}`` to ``fpn_output{n}``, ``conv2_offset`` and
``conv2_deform_weight`` to ``conv2.weight`` (HWIO to OIHW); every model
loads with ``strict=True``. A Detectron2-named checkpoint of fresh weights
(heads under ``roi_heads.``) goes into both packages: the names each
reports unmatched and missing are the same (the JAX package's missing
names in the port's naming), and ``inference_scores`` agree within rtol
1e-4, atol 1e-5 times the largest value. The JAX package's name map
reaches neither Cascade's per-stage heads, nor the FPN's convs, nor a
deformable block's ``conv2.weight``: those stay unloaded in both."""

import pickle

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.checkpoint import from_jax
from drn_wsod_torch.checkpoint.torch_import import load_reference_weights
from drn_wsod_tpu.checkpoint import torch_import as jimport
from test_torch_checkpoint_import import _jax_lists
from test_torch_common import (d2_state_dict, jax_batch, random_params,
                               unflatten)
from test_torch_pyramid_steps import CASES as PYRAMID_CASES
from test_torch_pyramid_steps import _batch as _pyramid_batch
from test_torch_pyramid_steps import _models as _pyramid_models
from test_torch_supervised import _gt_batch
from test_torch_supervised import _models as _supervised_models

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def test_port_names():
    cases = {
        "box_predictor.cls_score.kernel": "box_predictor.cls_score.weight",
        "cascade_head_2.fc1.bias": "box_head.2.fc1.bias",
        "cascade_predictor_0.bbox_pred.kernel":
            "box_predictor.0.bbox_pred.weight",
        "backbone.bottom_up.res3_1.conv2_norm.running_var":
            "backbone.bottom_up.res3.1.conv2.norm.running_var",
        "backbone.bottom_up.stem.conv1.kernel":
            "backbone.bottom_up.stem.conv1.weight",
        "backbone.fpn_lateral_res2.kernel": "backbone.fpn_lateral2.weight",
        "backbone.fpn_output_res5.bias": "backbone.fpn_output5.bias",
        "backbone.res4_0.conv2_offset.kernel":
            "backbone.res4.0.conv2_offset.weight",
        "backbone.res5_2.conv2_deform_weight": "backbone.res5.2.conv2.weight",
    }
    for flax_name, want in cases.items():
        assert from_jax.port_name(flax_name) == want
    w = np.arange(3 * 3 * 4 * 5, dtype=np.float32).reshape(3, 3, 4, 5)
    sd = drn_wsod_torch.params_from_jax(
        {"backbone.res5_2.conv2_deform_weight": w})
    np.testing.assert_array_equal(sd["backbone.res5.2.conv2.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))


def _case(case):
    """(jax model, flat params, port model, batch)."""
    if case in PYRAMID_CASES:
        jm, flat, pm, _, _ = _pyramid_models(case)
        _, _, size, classes = PYRAMID_CASES[case]
        return jm, flat, pm, _pyramid_batch(5, size, classes)
    head = {"fast_rcnn": "StandardROIHeads",
            "cascade": "CascadeROIHeads"}[case]
    jm, flat, pm, _, _ = _supervised_models("MODEL.ROI_HEADS.NAME", head)
    return jm, flat, pm, _gt_batch(5)


UNREACHED = {"fast_rcnn": (), "deform": ("conv2.weight",),
             "cascade": ("box_head.", "box_predictor."),
             "fpn": ("backbone.fpn_",)}


@pytest.mark.parametrize("case", ["fast_rcnn", "cascade", "fpn", "deform"])
def test_detectron2_import_matches_jax(case, tmp_path):
    jm, flat, pm, batch = _case(case)
    fresh = drn_wsod_torch.params_from_jax(random_params(
        {k: v.shape for k, v in flat.items()}, seed=7))
    path = tmp_path / "d2.pkl"
    with open(path, "wb") as f:
        pickle.dump({"model": d2_state_dict(fresh)}, f)
    unmatched, missing = load_reference_weights(str(path), pm)
    want_unmatched, want_missing = _jax_lists(str(path), flat)
    assert unmatched == want_unmatched
    # the same names (flax orders a module's leaves alphabetically)
    assert sorted(missing) == sorted(from_jax.port_name(k)
                                     for k in want_missing)
    unreached = UNREACHED[case]
    assert all(any(u in n for u in unreached) for n in missing)
    assert bool(missing) == bool(unreached)
    loaded = jimport.load_reference_weights(str(path),
                                            {"params": unflatten(flat)})
    want_s, want_b = jax.jit(lambda v, x: jm.apply(
        v, x, method="inference_scores"))(loaded, jax_batch(batch))
    got_s, got_b = pm.inference_scores(batch)
    for got, want in ((got_s, want_s), (got_b, want_b)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())
