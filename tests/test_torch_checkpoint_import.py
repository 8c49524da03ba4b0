"""The port's Detectron2 weight import (``checkpoint/torch_import.py``)
against the JAX package's ``load_reference_weights``, on a synthetic
Detectron2 state dict the test writes (``roi_heads.`` names, fc1 with a
(C, 7, 7) input, ``num_batches_tracked``, an anchor buffer, a name that
matches nothing, a tensor left out) as a ``.pkl`` with and without a
"model" key and as a ``.pth`` under "model" and, with ``module.`` names,
under "state_dict".

Both packages load the same file into models that start from the same
weights; their ``inference_scores`` must agree within
``tests/test_torch_slice.py``'s tolerance (rtol 1e-4, atol 1e-5 times the
largest value), and the names each reports as unmatched and missing must be
the same (the JAX package's missing names in the port's naming)."""

import logging
import pickle

import jax
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.checkpoint import from_jax
from drn_wsod_torch.checkpoint.torch_import import load_reference_weights
from drn_wsod_tpu.checkpoint import torch_import as jimport
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_common import (TOY, cfg_pair, d2_state_dict, jax_batch,
                               param_shapes, random_params, unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
LEFT_OUT = "box_refinery.2.cls_score.bias"


@pytest.fixture(scope="module")
def models():
    jc, pc = cfg_pair(*TOY, "MODEL.PIXEL_STD", [57.4, 57.1, 58.4],
                      "WSL.REFINE_REG", [False, False, True])
    batch = drn_wsod_torch.synthetic_batch(2, 64, 64, 64, 20, seed=5,
                                           device="cpu")
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    shapes = param_shapes(lambda: jm.init({"params": key, "dropout": key},
                                          jax_batch(batch), train=False))
    return jm, pc, batch, shapes


def _d2_state_dict(shapes, module_prefix=False):
    """Detectron2 names and layouts of a fresh weight draw, one tensor left
    out, with FrozenBN counters, an anchor buffer and a stray name."""
    sd = d2_state_dict(drn_wsod_torch.params_from_jax(
        random_params(shapes, seed=7)), module_prefix)
    del sd[("module." if module_prefix else "") + "roi_heads." + LEFT_OUT]
    for name in [k for k in sd if k.endswith("norm.running_var")]:
        sd[name.removeprefix("module.").replace(
            "running_var", "num_batches_tracked")] = np.array(0, np.int64)
    sd["anchor_generator.cell_anchors.0"] = np.zeros((3, 4), np.float32)
    sd["roi_heads.box_predictor.extra.weight"] = np.zeros((2, 2), np.float32)
    return sd


def _write(path, kind, sd):
    if kind == "pkl_model":
        with open(path, "wb") as f:
            pickle.dump({"model": sd, "__author__": "test"}, f)
    elif kind == "pkl_bare":
        with open(path, "wb") as f:
            pickle.dump(sd, f)
    else:
        tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
        key = "model" if kind == "pth_model" else "state_dict"
        torch.save({key: tensors, "iteration": 3}, path)


def _jax_lists(path, flat_params):
    """The JAX package's unmatched and missing names for ``path``, by its
    own name mapping (it logs them but does not return them)."""
    converted, unmatched = set(), []
    for name in jimport._load_state_dict(path):
        if name.endswith("num_batches_tracked") or name.startswith("anchor"):
            continue
        k = jimport._d2_name_to_flax(name)
        (converted.add(k) if k in flat_params else unmatched.append(name))
    return unmatched, [k for k in flat_params if k not in converted]


@pytest.mark.parametrize("kind", ["pkl_model", "pkl_bare", "pth_model",
                                  "pth_state_dict"])
def test_load_matches_jax(models, tmp_path, caplog, kind):
    jm, pc, batch, shapes = models
    init = random_params(shapes, seed=1)
    variables = {"params": unflatten(init)}
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(init), strict=True)

    path = str(tmp_path / ("w.pkl" if kind.startswith("pkl") else "w.pth"))
    _write(path, kind, _d2_state_dict(shapes, kind == "pth_state_dict"))
    with caplog.at_level(logging.WARNING):
        unmatched, missing = load_reference_weights(path, pm)
        loaded = jimport.load_reference_weights(path, variables)
    want_unmatched, want_missing = _jax_lists(path, init)
    assert unmatched == want_unmatched
    assert missing == [from_jax.port_name(k) for k in want_missing]
    assert missing == [LEFT_OUT]
    assert [u.removeprefix("module.") for u in unmatched] == \
        ["roi_heads.box_predictor.extra.weight"]
    counts = [r.getMessage().split(" ")[0] for r in caplog.records]
    assert counts == ["1", "1", "1", "1"]           # each logs both lists

    want_s, want_b = jax.jit(lambda v, b: jm.apply(
        v, b, method="inference_scores"))(loaded, jax_batch(batch))
    got_s, got_b = pm.inference_scores(batch)
    for got, want in ((got_s, want_s), (got_b, want_b)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())
    fresh = drn_wsod_torch.params_from_jax(random_params(shapes, seed=7))
    np.testing.assert_array_equal(pm.state_dict()["box_head.fc1.weight"],
                                  fresh["box_head.fc1.weight"])
    np.testing.assert_array_equal(pm.state_dict()[LEFT_OUT],
                                  drn_wsod_torch.params_from_jax(
                                      init)[LEFT_OUT])


def test_shape_mismatch_raises(models, tmp_path):
    _, pc, _, shapes = models
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    sd = _d2_state_dict(shapes)
    sd["roi_heads.box_predictor.cls.weight"] = np.zeros((3, 3), np.float32)
    path = str(tmp_path / "bad.pkl")
    _write(path, "pkl_bare", sd)
    with pytest.raises(ValueError, match="box_predictor.cls.weight"):
        load_reference_weights(path, pm)
