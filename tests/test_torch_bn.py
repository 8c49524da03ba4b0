"""The port's BatchNorm (``MODEL.RESNETS.NORM`` BN) against the JAX
package's, same weights, statistics and inputs, on the CPU.

The JAX backbone is never called in train mode, so its ``nn.BatchNorm``
always normalises with the running statistics and returns float32, whatever
the input's dtype. Tolerances:
- one BatchNorm: bit-equal to flax's (run op by op) on every channel whose
  ``rsqrt(var + eps)`` agrees, and both bit-equal to flax's formula in
  numpy float32 with their own ``rsqrt``. Torch's ``rsqrt`` on the CPU is
  ``1 / sqrt`` rounded twice (up to 1.09 ulp from the exact value on these
  inputs), XLA's is closer (up to 0.79 ulp); they differ by one ulp on 29
  of the 64 channels;
- towers: float32 rtol 1e-4, atol 1e-5 times the largest value (the
  convolutions' summation order); bfloat16 convs (the map float32): within
  one bfloat16 ulp of the largest value (rounding to bfloat16 at each conv
  input moves its successors by an ulp where the float32 values differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.checkpoint import from_jax
from drn_wsod_torch.models.backbones import resnet_ws as port
from drn_wsod_torch.solver import build as port_solver
from drn_wsod_tpu.models.backbones import resnet_ws as ref
from drn_wsod_tpu.solver import build as ref_solver
from test_torch_common import (TOY, cfg_pair, flatten, nhwc_to_port,
                               port_to_nhwc, random_params, unflatten)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def bn_variables(init_fn, seed: int = 0):
    """(flat params, flat batch_stats) of ``init_fn()`` drawn with numpy:
    the tower's convs as ``random_params`` draws them, each BatchNorm's
    scale in [0.3, 1], bias N(0, 0.1), mean N(0, 0.1), var in [0.5, 1.5]."""
    shapes = jax.eval_shape(init_fn)
    params = {k: tuple(v.shape) for k, v in flatten(shapes["params"]).items()}
    stats = {k: tuple(v.shape)
             for k, v in flatten(shapes["batch_stats"]).items()}
    rng = np.random.RandomState(seed + 1000)
    flat = random_params({k: s for k, s in params.items()
                          if not k.endswith(".scale")}, seed)
    for k in sorted(params):
        if k.endswith(".scale"):
            flat[k] = rng.uniform(0.3, 1.0, params[k]).astype(np.float32)
    bs = {}
    for k in sorted(stats):
        bs[k] = (rng.uniform(0.5, 1.5, stats[k]) if k.endswith(".var")
                 else rng.randn(*stats[k]) * 0.1).astype(np.float32)
    return flat, bs


def load_bn_prefixed(module, flat, stats, flax_prefix, port_prefix):
    """``load_prefixed`` with the batch_stats through the bridge too."""
    sd = drn_wsod_torch.params_from_jax(
        {flax_prefix + k: v for k, v in flat.items()},
        {flax_prefix + k: v for k, v in stats.items()})
    module.load_state_dict({k[len(port_prefix):]: v for k, v in sd.items()},
                           strict=True)


def _ulp(a: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(a).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(dtype):
    import flax.linen as nn

    rs = np.random.RandomState(0)
    C = 64
    x = (rs.randn(2, 9, 9, C) * 3).astype(np.float32)
    mean = rs.randn(C).astype(np.float32)
    var = rs.uniform(0.01, 2.0, C).astype(np.float32)
    scale = rs.uniform(0.3, 1.5, C).astype(np.float32)
    bias = rs.randn(C).astype(np.float32)
    jm = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    want = jm.apply({"params": {"scale": scale, "bias": bias},
                     "batch_stats": {"mean": mean, "var": var}}, xj)
    assert want.dtype == jnp.float32
    want = np.asarray(want)

    bn = port.BatchNorm(C)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(v))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = bn(xt.permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    got = port_to_nhwc(got)

    r_jax = np.asarray(jax.lax.rsqrt(jnp.asarray(var + np.float32(1e-5))))
    r_port = torch.rsqrt(torch.from_numpy(var) + 1e-5).numpy()
    exact = 1.0 / np.sqrt((var + np.float32(1e-5)).astype(np.float64))
    for r in (r_jax, r_port):
        assert (np.abs(r - exact) <= 1.1 * _ulp(r)).all()
    assert (np.abs(r_jax - r_port) <= _ulp(r_jax)).all()
    same = r_jax == r_port
    assert 0 < same.sum() < C          # both kinds of channel are present
    np.testing.assert_array_equal(got[..., same], want[..., same])
    x32 = np.asarray(xj.astype(jnp.float32))

    def flax_formula(r):
        """``(x - mean) * (r * scale) + bias``, each step in float32."""
        return (x32 - mean) * (r * scale) + bias

    np.testing.assert_array_equal(want, flax_formula(r_jax))
    np.testing.assert_array_equal(got, flax_formula(r_port))


@pytest.mark.parametrize("norm", ["BN", "SyncBN", "naiveSyncBN", "FrozenBN",
                                  "GN", ""])
def test_norm_dispatch_matches_jax(norm):
    """BN, SyncBN and naiveSyncBN give BatchNorm; every other value,
    "GN" included, FrozenBN, as the JAX package's ``_norm_layer`` does."""
    import flax.linen as nn

    want_bn = isinstance(ref._norm_layer(norm, 8, "n"), nn.BatchNorm)
    got = port.norm_layer(norm, 8)
    assert isinstance(got, port.BatchNorm) == want_bn
    assert isinstance(got, port.FrozenBatchNorm) == (not want_bn)


def _tower_check(jm, pm, x, dtype):
    xj = jnp.asarray(x, jnp.dtype(dtype))
    flat, stats = bn_variables(lambda: jm.init(jax.random.PRNGKey(0), xj))
    want = jm.apply({"params": unflatten(flat),
                     "batch_stats": unflatten(stats)}, xj)["res5"]
    load_bn_prefixed(pm, flat, stats, "backbone.", "backbone.")
    with torch.no_grad():
        got = pm(nhwc_to_port(x).to(getattr(torch, dtype)).contiguous(
            memory_format=torch.channels_last))["res5"]
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    got, want = port_to_nhwc(got), np.asarray(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kwargs", [
    dict(depth=18, stem_out_channels=16, width_per_group=16,
         res2_out_channels=64),
    dict(depth=50, stem_out_channels=16, width_per_group=8,
         res2_out_channels=32),
], ids=["r18", "narrow_r50"])
def test_ws_tower_bn_matches_jax(kwargs, dtype):
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    jm = ref.ResNetWS(res5_dilation=2, norm="BN", dtype=jnp.dtype(dtype),
                      **kwargs)
    pm = port.ResNetWS(res5_dilation=2, norm="BN", dtype=getattr(
        torch, dtype), **kwargs)
    _tower_check(jm, pm, x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [18, 50])
def test_plain_tower_bn_matches_jax(depth, dtype):
    kwargs = dict(depth=depth, stem_out_channels=16, width_per_group=8,
                  res2_out_channels=64 if depth == 18 else 32)
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    jm = ref.ResNetPlain(res5_dilation=2, norm="BN", dtype=jnp.dtype(dtype),
                         **kwargs)
    pm = port.ResNetPlain(res5_dilation=2, norm="BN", dtype=getattr(
        torch, dtype), **kwargs)
    _tower_check(jm, pm, x, dtype)


def test_bridge_carries_batch_stats():
    """flax BatchNorm's scale and bias (params) and mean and var
    (batch_stats) land in ``norm.weight``, ``norm.bias`` and the
    ``norm.running_*`` buffers; a FrozenBN tower's names are as before."""
    jm = ref.BasicStem(16, norm="BN")
    x = jnp.zeros((1, 16, 16, 3))
    flat, stats = bn_variables(lambda: jm.init(jax.random.PRNGKey(0), x))
    sd = drn_wsod_torch.params_from_jax(
        {"backbone.stem." + k: v for k, v in flat.items()},
        {"backbone.stem." + k: v for k, v in stats.items()})
    assert sd["backbone.stem.conv2.norm.weight"].numpy().tolist() == \
        flat["conv2_norm.scale"].tolist()
    assert sd["backbone.stem.conv2.norm.running_var"].numpy().tolist() == \
        stats["conv2_norm.var"].tolist()
    assert from_jax.port_name("backbone.res2_0.conv1_norm.mean") == \
        "backbone.res2.0.conv1.norm.running_mean"
    pm = port.BasicStem(16, norm="BN")
    pm.load_state_dict({k[len("backbone.stem."):]: v for k, v in sd.items()},
                       strict=True)
    assert isinstance(pm.conv1.norm, port.BatchNorm)
    assert {n for n, _ in pm.named_buffers()} == {
        f"conv{i}.norm.running_{s}" for i in (1, 2, 3)
        for s in ("mean", "var")}
    with pytest.raises(KeyError, match="maps to no port tensor"):
        drn_wsod_torch.params_from_jax({}, {"backbone.stem.conv1_norm.x":
                                            np.zeros(3, np.float32)})


def test_build_model_keeps_bn_float32_and_frozen():
    """Under NORM BN and bfloat16, the frozen convs are stored in bfloat16
    while BatchNorm's affine stays a float32 parameter without gradient and
    its statistics float32 buffers; the solver labels the affine frozen and
    puts no buffer in a group, as the JAX package labels its leaves."""
    _, pc = cfg_pair(*TOY, "MODEL.RESNETS.NORM", "BN",
                     "MODEL.DTYPE", "bfloat16", "MODEL.BACKBONE.FREEZE_AT", 2)
    m = drn_wsod_torch.build_model(pc, device="cpu")
    params = dict(m.named_parameters())
    norms = [n for n in params if ".norm." in n]
    assert norms and all(params[n].dtype == torch.float32
                         and not params[n].requires_grad for n in norms)
    assert params["backbone.stem.conv1.weight"].dtype == torch.bfloat16
    assert params["backbone.res3.0.conv1.weight"].dtype == torch.float32
    assert params["backbone.res3.0.conv1.weight"].requires_grad
    buffers = {n for n, _ in m.named_buffers(remove_duplicate=False)}
    assert "backbone.res5.1.conv2.norm.running_var" in buffers
    tx = port_solver.build_optimizer(pc, m)
    assert set(tx.labels) == set(params)
    assert all(tx.labels[n] == "frozen" for n in norms)
    # the JAX package labels the same leaves, batch_stats included
    tree = {"backbone": {"res3_0": {"conv1_norm": {"scale": np.ones(2),
                                                   "bias": np.ones(2),
                                                   "mean": np.ones(2),
                                                   "var": np.ones(2)},
                                    "conv1": {"kernel": np.ones((1, 1, 2,
                                                                 2))}}}}
    want = flatten(ref_solver.make_param_labels(tree, 2))
    got = port_solver.make_param_labels(
        [from_jax.port_name(k) for k in want], 2)
    assert list(got.values()) == list(want.values())
    assert sorted(want.values()) == ["frozen"] * 4 + ["weight"]


def test_d2_import_under_bn_matches_jax(tmp_path):
    """A Detectron2 state dict into a NORM BN detector does what the JAX
    package's import does with it: of each BatchNorm only ``norm.bias``
    loads; ``norm.weight`` and the running statistics are unmatched (flax
    names the scale ``scale`` and keeps the statistics out of its params),
    the model's ``norm.weight`` is missing, and the statistics keep their
    values."""
    import pickle

    from drn_wsod_torch.checkpoint.torch_import import load_reference_weights
    from drn_wsod_tpu.checkpoint import torch_import as jimport
    from drn_wsod_tpu.models import build_model as jax_build_model
    from test_torch_common import d2_state_dict, jax_batch

    jc, pc = cfg_pair(*TOY, "MODEL.RESNETS.NORM", "BN")
    batch = drn_wsod_torch.synthetic_batch(1, 64, 64, 16, 20, seed=5,
                                           device="cpu")
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    init_fn = lambda: jm.init({"params": key, "dropout": key},  # noqa: E731
                              jax_batch(batch), train=False)
    init, init_stats = bn_variables(init_fn, seed=1)
    d2_params, d2_stats = bn_variables(init_fn, seed=7)
    sd = d2_state_dict(drn_wsod_torch.params_from_jax(d2_params, d2_stats))
    path = str(tmp_path / "w.pkl")
    with open(path, "wb") as f:
        pickle.dump({"model": sd}, f)

    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(init, init_stats),
                       strict=True)
    unmatched, missing = load_reference_weights(path, pm)
    loaded = jimport.load_reference_weights(
        path, {"params": unflatten(init), "batch_stats": unflatten(
            init_stats)})

    converted, want_unmatched = set(), []
    for name in sd:
        k = jimport._d2_name_to_flax(name)
        (converted.add(k) if k in init else want_unmatched.append(name))
    want_missing = [from_jax.port_name(k) for k in init
                    if k not in converted]
    assert unmatched == want_unmatched
    assert sorted(missing) == sorted(want_missing)
    assert missing and all(k.endswith(".norm.weight") for k in missing)
    assert {u.rsplit(".", 1)[1] for u in unmatched} == {
        "weight", "running_mean", "running_var"}
    want = drn_wsod_torch.params_from_jax(flatten(loaded["params"]),
                                          flatten(loaded["batch_stats"]))
    got = pm.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].float().numpy(), v.numpy(),
                                      err_msg=k)
    np.testing.assert_array_equal(
        got["backbone.res2.0.conv1.norm.bias"].numpy(),
        d2_params["backbone.res2_0.conv1_norm.bias"])
    np.testing.assert_array_equal(
        got["backbone.res2.0.conv1.norm.running_mean"].numpy(),
        init_stats["backbone.res2_0.conv1_norm.mean"])
