"""The port's heads and box ops against the JAX package's, same weights and
inputs. Tolerance (float32): rtol 1e-5, atol 1e-6 — only the matrix
products' summation order differs; box ops are elementwise and exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.models.heads import box_head as port_box_head
from drn_wsod_torch.models.heads import oicr as port_oicr
from drn_wsod_torch.models.heads import wsddn as port_wsddn
from drn_wsod_torch.structures import boxes as port_boxes
from drn_wsod_tpu.models.heads import box_head as ref_box_head
from drn_wsod_tpu.models.heads import oicr as ref_oicr
from drn_wsod_tpu.models.heads import wsddn as ref_wsddn
from drn_wsod_tpu.structures import boxes as ref_boxes
from test_torch_common import param_shapes, random_params, unflatten

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _load_dense(module: torch.nn.Module, flat: dict) -> None:
    """Copy flax Dense params {'<name>.kernel', '<name>.bias'} into the
    same-named torch Linear submodules."""
    sd = {}
    for k, v in flat.items():
        name, leaf = k.rsplit(".", 1)
        if leaf == "kernel":
            sd[f"{name}.weight"] = torch.from_numpy(v.T.copy())
        else:
            sd[f"{name}.bias"] = torch.from_numpy(v)
    module.load_state_dict(sd, strict=True)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_dan_eval():
    x = np.random.RandomState(0).randn(10, 7 * 7 * 8).astype(np.float32)
    jm = ref_box_head.DiscriminativeAdaptionNeck(dan_dims=(32, 16))
    flat = random_params(param_shapes(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=1)
    want = jm.apply({"params": unflatten(flat)}, jnp.asarray(x), train=False)
    pm = port_box_head.DiscriminativeAdaptionNeck(7 * 7 * 8, (32, 16))
    _load_dense(pm, flat)
    with torch.no_grad():
        _close(pm(torch.from_numpy(x)), want)


@pytest.mark.parametrize("all_masked_image", [False, True])
def test_wsddn_masked(all_masked_image):
    """Masked proposal softmax; padded rows zero. With one image fully
    masked, both sides give that image all zeros (not NaN)."""
    rng = np.random.RandomState(2)
    B, P, D, C = 2, 12, 16, 5
    x = rng.randn(B, P, D).astype(np.float32)
    mask = rng.uniform(0, 1, (B, P)) > 0.3
    if all_masked_image:
        mask[1] = False
    jm = ref_wsddn.WSDDNOutputLayers(num_classes=C)
    flat = random_params(param_shapes(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))), seed=3)
    want = jm.apply({"params": unflatten(flat)}, jnp.asarray(x),
                    jnp.asarray(mask))
    pm = port_wsddn.WSDDNOutputLayers(D, C)
    _load_dense(pm, flat)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    assert (got[~torch.from_numpy(mask)] == 0).all()
    _close(got, want)
    _close(port_wsddn.image_probs(got), ref_wsddn.image_probs(want))
    _close(port_wsddn.append_background(got),
           ref_wsddn.append_background(want))


@pytest.mark.parametrize("agnostic", [False, True])
def test_refinement_branches(agnostic):
    """Branch logits and deltas (float32), branch_probs and the mean of the
    branch softmaxes."""
    rng = np.random.RandomState(4)
    B, P, D, C, K = 2, 9, 16, 5, 3
    x = rng.randn(B, P, D).astype(np.float32)
    jm = ref_oicr.RefinementOutputLayers(num_classes=C,
                                         cls_agnostic_bbox_reg=agnostic)
    shapes = param_shapes(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    logits_j, logits_p = [], []
    for k in range(K):
        flat = random_params(shapes, seed=10 + k)
        cls_j, deltas_j = jm.apply({"params": unflatten(flat)}, jnp.asarray(x))
        pm = port_oicr.RefinementOutputLayers(D, C, agnostic)
        _load_dense(pm, flat)
        with torch.no_grad():
            cls_p, deltas_p = pm(torch.from_numpy(x))
        assert cls_p.dtype == deltas_p.dtype == torch.float32
        assert deltas_p.shape[-1] == (4 if agnostic else 4 * C)
        _close(cls_p, cls_j)
        _close(deltas_p, deltas_j)
        logits_j.append(cls_j)
        logits_p.append(cls_p)
    _close(port_oicr.branch_probs(logits_p[-1]),
           ref_oicr.branch_probs(logits_j[-1]))
    _close(port_oicr.average_branch_probs(logits_p),
           ref_oicr.average_branch_probs(logits_j))


def _random_boxes(rng, n, lo=-20.0, hi=120.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(-10, 60, (n, 2))         # some degenerate / inverted
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_area_clip_pairwise_iou():
    rng = np.random.RandomState(5)
    a, b = _random_boxes(rng, 17), _random_boxes(rng, 11)
    b[:3] = a[:3]                               # identical pairs: IoU 1
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(port_boxes.area(ta).numpy(),
                                  np.asarray(ref_boxes.area(jnp.asarray(a))))
    np.testing.assert_array_equal(
        port_boxes.clip(ta, (50, 70)).numpy(),
        np.asarray(ref_boxes.clip(jnp.asarray(a), (50, 70))))
    hw = np.array([50, 70], np.int32)
    np.testing.assert_array_equal(
        port_boxes.clip(ta, torch.from_numpy(hw)).numpy(),
        np.asarray(ref_boxes.clip(jnp.asarray(a), jnp.asarray(hw))))
    _close(port_boxes.pairwise_iou(ta, tb),
           ref_boxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    # batched leading dims == the vmapped JAX function
    a2 = np.stack([a, a[::-1].copy()])
    _close(port_boxes.pairwise_iou(torch.from_numpy(a2), torch.from_numpy(a2)),
           jax.vmap(ref_boxes.pairwise_iou)(jnp.asarray(a2), jnp.asarray(a2)))


@pytest.mark.parametrize("k", [1, 5])
def test_apply_deltas(k):
    rng = np.random.RandomState(6)
    boxes = _random_boxes(rng, 2 * 13).reshape(2, 13, 4)
    deltas = (rng.randn(2, 13, 4 * k) * 2).astype(np.float32)
    deltas[0, 0, 2] = 50.0                      # hits the scale clamp
    _close(port_boxes.apply_deltas(torch.from_numpy(deltas),
                                   torch.from_numpy(boxes)),
           ref_boxes.apply_deltas(jnp.asarray(deltas), jnp.asarray(boxes)))
