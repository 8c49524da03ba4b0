"""The port's PreciseBN (``engine/precise_bn.py:update_bn_stats`` and
``engine/hooks.py:PreciseBNHook``) against the JAX package's, bit for bit.

- The toy model of ``tests/test_precise_bn.py`` (a flax ``nn.BatchNorm``
  whose train forward updates its statistics): the port's counterpart
  computes flax's train-mode statistics, run in place of the detector's
  train forward (``precise_bn.train_forward``). The batches hold multiples
  of 1/4 whose sums are exact in float32, so the two reductions' orders
  cannot part them and the comparison sees PreciseBN's own float32
  arithmetic.
- The toy NORM BN detector: its backbone never updates the statistics, so
  each run of PreciseBN only rounds them, in both packages alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.engine import (PreciseBNHook, Trainer, TrainState,
                                   update_bn_stats)
from drn_wsod_torch.engine import precise_bn
from drn_wsod_torch.models.backbones.resnet_ws import BatchNorm
from drn_wsod_tpu.engine import PreciseBNHook as JaxPreciseBNHook
from drn_wsod_tpu.engine import Trainer as JaxTrainer
from drn_wsod_tpu.engine import create_train_state as jax_train_state
from drn_wsod_tpu.engine.precise_bn import \
    update_bn_stats as jax_update_bn_stats
from drn_wsod_tpu.models import build_model as jax_build_model
from test_torch_bn import bn_variables
from test_torch_common import TOY, cfg_pair, flatten, jax_batch, unflatten

torch.set_num_threads(1)


class ToyBN(BatchNorm):
    """flax's ``nn.BatchNorm(momentum=0.9)`` in train mode on (N, C):
    batch mean and ``max(0, mean(x^2) - mean^2)``, folded into the running
    statistics as ``0.9 * old + (1 - 0.9) * batch`` in float32."""

    def forward(self, x):
        mean = x.mean(0)
        var = torch.clamp((x * x).mean(0) - mean * mean, min=0.0)
        m = torch.full_like(mean, 0.9)
        one_minus_m = torch.full_like(mean, 1.0 - 0.9)
        self.running_mean.copy_(m * self.running_mean + one_minus_m * mean)
        self.running_var.copy_(m * self.running_var + one_minus_m * var)
        return x


def _toy(rs, n, rows, loc, scale):
    """``n`` (rows, 4) float32 batches of multiples of 1/4."""
    return [(np.round(rs.normal(loc, scale, (rows, 4)) * 4) / 4).astype(
        np.float32) for _ in range(n)]


def _jax_toy():
    import flax.linen as nn

    class TinyBN(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = True):
            return nn.BatchNorm(momentum=0.9,
                                use_running_average=not train)(x)
    return TinyBN()


def _toy_forward(monkeypatch, calls=None):
    """The toy's forward in place of the detector's train forward."""
    def forward(model, batch):
        if calls is not None:
            calls.append(1)
        model(batch)
    monkeypatch.setattr(precise_bn, "train_forward", forward)


@pytest.mark.parametrize("num_iters,n_batches", [(50, 50), (8, 12), (5, 3)])
def test_update_bn_stats_bit_equal_on_toy(num_iters, n_batches,
                                          monkeypatch):
    data = _toy(np.random.RandomState(0), n_batches, 32, 3.0, 2.0)
    jm = _jax_toy()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(data[0]))
    out = jax_update_bn_stats(
        lambda v, b, mutable: jm.apply(v, b, train=True, mutable=mutable),
        variables, iter([jnp.asarray(d) for d in data]), num_iters)
    want = {k: np.asarray(out["batch_stats"]["BatchNorm_0"][k])
            for k in ("mean", "var")}

    bn = ToyBN(4)
    _toy_forward(monkeypatch)
    n = update_bn_stats(bn, iter([torch.from_numpy(d) for d in data]),
                        num_iters)
    assert n == min(num_iters, n_batches)
    np.testing.assert_array_equal(bn.running_mean.numpy(), want["mean"])
    np.testing.assert_array_equal(bn.running_var.numpy(), want["var"])
    if num_iters == 50:                 # the true statistics, as JAX's test
        np.testing.assert_allclose(want["mean"], 3.0, atol=0.2)
        np.testing.assert_allclose(want["var"], 4.0, rtol=0.2)


def test_update_bn_stats_leaves_a_model_without_bn(monkeypatch):
    model = torch.nn.Linear(3, 3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    calls = []
    _toy_forward(monkeypatch, calls)
    assert update_bn_stats(model, iter([1, 2]), 10) == 0
    assert not calls
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    assert jax_update_bn_stats(None, {"params": {}}, iter([]), 10) == \
        {"params": {}}


@pytest.mark.parametrize("period,max_iter", [(1000, 1), (2, 5), (1, 3)])
def test_hook_bit_equal_to_jax(period, max_iter, monkeypatch):
    """The hook runs every ``period`` iterations but the last, and after
    training, each time over a fresh iterator: the JAX trainer's toy run
    of ``tests/test_precise_bn.py``, here for several periods."""
    from functools import partial

    import optax

    rs = np.random.RandomState(0)
    batches = _toy(rs, 10, 8, 5.0, 3.0)
    jm = _jax_toy()
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]))
    jax_calls, port_calls = [], []

    def jax_apply(v, b, mutable):
        jax_calls.append(1)
        return partial(jm.apply, train=True)(v, b, mutable=mutable)

    def jstep(state, batch, rng):
        return state, {"total_loss": jnp.zeros(())}

    jt = JaxTrainer(jstep, jax_train_state(variables, optax.sgd(0.0)),
                    iter([jnp.asarray(b) for b in batches] * max_iter),
                    jax.random.PRNGKey(0))
    jt.register_hooks([JaxPreciseBNHook(
        period, jax_apply, lambda: iter([jnp.asarray(b) for b in batches]),
        num_iters=8)])
    jt.train(0, max_iter)
    want = jt.state.params["batch_stats"]["BatchNorm_0"]

    bn = ToyBN(4)

    def pstep(state, batch, seed):
        return state, {"total_loss": torch.zeros(())}

    _toy_forward(monkeypatch, port_calls)
    pt = Trainer(pstep, TrainState(step=0, model=bn, opt_state={}),
                 iter([torch.from_numpy(b) for b in batches] * max_iter),
                 device="cpu")
    pt.register_hooks([PreciseBNHook(
        period, lambda: iter([torch.from_numpy(b) for b in batches]),
        num_iters=8)])
    pt.train(0, max_iter)
    assert len(port_calls) == len(jax_calls) == 8 * (
        1 + len([i for i in range(max_iter - 1) if (i + 1) % period == 0]))
    np.testing.assert_array_equal(bn.running_mean.numpy(),
                                  np.asarray(want["mean"]))
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  np.asarray(want["var"]))
    assert np.all(np.abs(bn.running_mean.numpy() - 5.0) < 1.0)


@pytest.fixture(scope="module")
def bn_detector():
    """The toy NORM BN detector of both packages with the same numpy
    weights and statistics, and four batches."""
    jc, pc = cfg_pair(*TOY, "MODEL.RESNETS.NORM", "BN")
    batches = [drn_wsod_torch.synthetic_batch(2, 64, 64, 16, 20, seed=s,
                                              device="cpu")
               for s in range(4)]
    jm = jax_build_model(jc)
    key = jax.random.PRNGKey(0)
    flat, stats = bn_variables(lambda: jm.init(
        {"params": key, "dropout": key}, jax_batch(batches[0]), train=False),
        seed=2)
    return jm, pc, batches, flat, stats


def test_update_bn_stats_on_the_bn_detector(bn_detector, monkeypatch):
    """Each run only rounds the statistics, bit for bit as JAX's: the
    detector's train forward (dropout on) runs once a batch and its
    backbone leaves the statistics as they were."""
    from functools import partial

    jm, pc, batches, flat, stats = bn_detector
    variables = {"params": unflatten(flat), "batch_stats": unflatten(stats)}
    want = variables
    pm = drn_wsod_torch.build_model(pc, device="cpu")
    pm.load_state_dict(drn_wsod_torch.params_from_jax(flat, stats),
                       strict=True)
    seen = []
    train_forward = precise_bn.train_forward

    def forward(m, b):
        seen.append(b)
        train_forward(m, b)
    monkeypatch.setattr(precise_bn, "train_forward", forward)
    for _ in range(2):                  # twice: the rounding compounds
        want = jax_update_bn_stats(
            partial(jm.apply, train=True,
                    rngs={"dropout": jax.random.PRNGKey(0)}),
            want, iter([jax_batch(b) for b in batches]), 3)

        assert update_bn_stats(pm, iter(batches), 3) == 3
    assert len(seen) == 6
    got = pm.state_dict()
    ref = drn_wsod_torch.params_from_jax({}, flatten(want["batch_stats"]))
    assert len(ref) == 2 * sum(isinstance(m, BatchNorm)
                               for m in pm.modules())
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    var = got["backbone.res2.0.conv1.norm.running_var"].numpy()
    assert not np.array_equal(var, stats["backbone.res2_0.conv1_norm.var"])
    np.testing.assert_allclose(var, stats["backbone.res2_0.conv1_norm.var"],
                               rtol=1e-6)
