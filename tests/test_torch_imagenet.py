"""The ImageNet pretraining tool against the JAX tool (``tools/imagenet.py``,
loaded by path), on the CPU: the JAX ``ResNetWSClassifier`` (WS-R18,
``NORM`` BN, DAN (512, 64), 10 classes, dropout 0) and the port's with
the same numpy weights, 3 steps of the tool's optax chain (decay 1e-4,
trace 0.9, the piecewise schedule) on the tool's synthetic batches, BN on
batch statistics: the 3 losses within rtol 5e-3, and each tensor's
change in the first step (parameters and running statistics) within 2%
of its largest element plus 1e-7. Later steps' parameters are not
compared: a 1e-6 relative nudge of the weights moves the port's own
3-step change by up to 28% in some tensor. The first gradients agree
within 2e-5 of each tensor's largest from the top of the network down to
``res2.1.conv2``; below it XLA's float32 gradient parts from a float64
one by up to 1.3e-2 of the largest (``res2.1.conv1.weight``), where the
port's float32 gradient stays within 1e-5 of it
(``test_gradients_against_float64``): that is what the tolerances above
absorb. The logits in eval mode (running
statistics) against flax's ``train=False``; the tool's ``main`` end to
end on synthetic data and an image folder of JPEGs."""

import copy
import importlib.util
from contextlib import contextmanager
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import drn_wsod_torch
from drn_wsod_torch.models.backbones.resnet_ws import (
    build_ws_resnet_backbone, use_batch_stats)
from drn_wsod_torch.tools import imagenet as pim
from drn_wsod_tpu.config import get_cfg as jax_get_cfg
from drn_wsod_tpu.models.backbones import \
    build_ws_resnet_backbone as jax_backbone
from test_torch_common import flatten, unflatten

torch.set_num_threads(2)

SIZE, B, NC, DAN = 64, 4, 10, (512, 64)
LR, ITERS = 0.002, 6         # boundaries at 1 and 4: steps 1-2 at lr / 10


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_imagenet",
        Path(__file__).resolve().parents[1] / "tools" / "imagenet.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfgs():
    out = []
    for get_cfg in (jax_get_cfg, drn_wsod_torch.get_cfg):
        cfg = get_cfg()
        cfg.MODEL.RESNETS.DEPTH = 18
        cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
        cfg.MODEL.RESNETS.RES5_DILATION = 1
        cfg.MODEL.RESNETS.NORM = "BN"
        cfg.MODEL.DTYPE = "float32"
        out.append(cfg)
    return out


def _port_sd(params, stats):
    """The port's state dict: the backbone through ``params_from_jax``,
    the DAN and ``fc`` (flax Dense: kernel (in, out)) transposed."""
    sd = dict(drn_wsod_torch.params_from_jax(
        {k: v for k, v in params.items() if k.startswith("backbone.")},
        stats))
    for k, v in params.items():
        if not k.startswith("backbone."):
            mod, leaf = k.rsplit(".", 1)
            v = np.asarray(v)
            sd[f"{mod}.{'weight' if leaf == 'kernel' else 'bias'}"] = \
                torch.from_numpy(np.ascontiguousarray(
                    v.T if leaf == "kernel" else v))
    return sd


@pytest.fixture(scope="module")
def pair():
    jt = _jax_tool()
    jc, pc = _cfgs()
    jb, _, _ = jax_backbone(jc)
    jm = jt.ResNetWSClassifier(backbone=jb, dan_dims=DAN, num_classes=NC,
                               dropout=0.0)
    batches = list(zip(range(3), pim.synthetic_batches(B, SIZE, NC)))
    x0 = jnp.asarray(batches[0][1][0])
    mean = jnp.asarray(pim.PIXEL_MEAN)
    key = jax.random.PRNGKey(0)
    variables = jm.init({"params": key, "dropout": key}, x0 - mean,
                        train=True)
    rng = np.random.RandomState(0)
    params = {k: (rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1]))
                  if k.endswith("kernel") else
                  rng.uniform(0.5, 1.5, v.shape) if k.endswith("scale")
                  else rng.randn(*v.shape) * 0.1).astype(np.float32)
              for k, v in flatten(variables["params"]).items()}
    stats = {k: (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var")
                 else rng.randn(*v.shape) * 0.1).astype(np.float32)
             for k, v in flatten(variables["batch_stats"]).items()}

    backbone = build_ws_resnet_backbone(pc)
    pm = pim.ResNetWSClassifier(
        backbone, pim.pooled_features(backbone, SIZE), DAN, NC, 0.0)
    pm.load_state_dict(_port_sd(params, stats), strict=True)
    for p in pm.parameters():
        p.requires_grad_(True)
    return jm, params, stats, pm, [b for _, b in batches]


def _jax_steps(jm, params, stats, batches):
    """The JAX tool's step (``tools/imagenet.py:main``) over ``batches``."""
    mean = jnp.asarray(pim.PIXEL_MEAN)
    sched = optax.piecewise_constant_schedule(
        LR, {int(ITERS * 0.33): 0.1, int(ITERS * 0.67): 0.1})
    tx = optax.chain(optax.add_decayed_weights(1e-4),
                     optax.trace(decay=0.9),
                     optax.scale_by_learning_rate(sched))
    p, bs = unflatten(params), unflatten(stats)
    opt = tx.init(p)
    losses = []

    @jax.jit
    def step(p, bs, opt, x, y):
        def loss_fn(p):
            logits, new = jm.apply({"params": p, "batch_stats": bs}, x - mean,
                                   train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), new

        (loss, new), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        u, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, u), new["batch_stats"], opt, loss

    for x, y in batches:
        p, bs, opt, loss = step(p, bs, opt, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return flatten(p), flatten(bs), losses


def _port_steps(pm, params, stats, batches):
    pm = copy.deepcopy(pm)
    pm.load_state_dict(_port_sd(params, stats))
    use_batch_stats(pm, True)
    step = pim.make_step(pm, LR, ITERS)
    trace, losses = {}, []
    for it, (x, y) in enumerate(batches):
        loss, _ = step(trace, torch.from_numpy(x),
                       torch.from_numpy(y).long(), it)
        losses.append(float(loss))
    return pm.state_dict(), losses


def test_steps_match_jax_tool(pair):
    jm, params, stats, pm, batches = pair
    _, _, jlosses = _jax_steps(jm, params, stats, batches)
    _, losses = _port_steps(pm, params, stats, batches)
    np.testing.assert_allclose(losses, jlosses, rtol=5e-3)
    # the first step's change of every tensor, parameters and statistics
    jp, jbs, _ = _jax_steps(jm, params, stats, batches[:1])
    sd, _ = _port_steps(pm, params, stats, batches[:1])
    want = _port_sd({k: np.asarray(v) for k, v in jp.items()},
                    {k: np.asarray(v) for k, v in jbs.items()})
    assert set(sd) == set(want)
    init = _port_sd(params, stats)
    for k in sorted(want):
        moved = (want[k] - init[k]).abs().max().item()
        err = (sd[k] - want[k]).abs().max().item()
        assert moved > 0 and err <= 0.02 * moved + 1e-7, (k, err, moved)


def test_eval_mode_uses_running_statistics(pair):
    jm, params, stats, pm, batches = pair
    pm = pim.ResNetWSClassifier(pm.backbone, pm.neck.fc1.in_features, DAN,
                                NC, 0.0)
    pm.load_state_dict(_port_sd(params, stats))
    use_batch_stats(pm, False)
    x = batches[0][0]
    mean = np.asarray(pim.PIXEL_MEAN, np.float32)
    want = jm.apply({"params": unflatten(params),
                     "batch_stats": unflatten(stats)}, jnp.asarray(x - mean),
                    train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(x - mean))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def test_lr_schedule_as_optax():
    sched = optax.piecewise_constant_schedule(
        LR, {int(ITERS * 0.33): 0.1, int(ITERS * 0.67): 0.1})
    for it in range(ITERS + 2):
        assert pim.lr_at(LR, ITERS, it) == float(np.float32(sched(it)))


def test_main_synthetic_and_imagefolder(tmp_path):
    from drn_wsod_torch.native import jpeg_encode

    out = pim.main(["--synthetic", "--depth", "18", "--batch-size", "2",
                    "--iters", "2", "--num-classes", "5", "--out",
                    str(tmp_path / "syn")], device="cpu")
    assert np.isfinite(out["loss"])
    assert (tmp_path / "syn" / "model_0000002.pth").exists()
    rs = np.random.RandomState(0)
    for c in ("cat", "dog"):
        (tmp_path / "folder" / c).mkdir(parents=True)
        for i in range(2):
            img = rs.randint(0, 256, (40 + i, 50, 3)).astype(np.uint8)
            (tmp_path / "folder" / c / f"{i}.jpg").write_bytes(
                jpeg_encode(img))
    batches = pim.imagefolder_batches(str(tmp_path / "folder"), 2, 32)
    x, y = next(batches)
    assert x.shape == (2, 32, 32, 3) and x.dtype == np.float32
    assert set(y) <= {0, 1}


def test_gradients_against_float64(pair):
    """The port's float32 gradients of step 0 against the same model in
    float64: within 1e-4 of each tensor's largest; XLA's within 2e-2."""
    jm, params, stats, pm, batches = pair
    x, y = batches[0]
    mean = np.asarray(pim.PIXEL_MEAN, np.float32)

    def grads(model, dtype):
        model = copy.deepcopy(model).to(dtype)
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = dtype
        use_batch_stats(model, True)
        ps = dict(model.named_parameters())
        logits = model(torch.from_numpy(x - mean).to(dtype))
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y).long())
        return dict(zip(ps, torch.autograd.grad(loss, list(ps.values()))))

    pm = pim.ResNetWSClassifier(pm.backbone, pm.neck.fc1.in_features, DAN,
                                NC, 0.0)
    pm.load_state_dict(_port_sd(params, stats))
    for p in pm.parameters():
        p.requires_grad_(True)
    g32 = grads(pm, torch.float32)
    with _float64_batch_norm():
        g64 = grads(pm, torch.float64)

    def loss_fn(p):
        logits, _ = jm.apply({"params": p, "batch_stats": unflatten(stats)},
                             jnp.asarray(x - mean), train=True,
                             mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    gj = _port_sd({k: np.asarray(v) for k, v in flatten(
        jax.grad(loss_fn)(unflatten(params))).items()}, stats)
    worst_port = worst_jax = 0.0
    for k, want in g64.items():
        scale = want.abs().max().item()
        worst_port = max(worst_port, (g32[k].double() - want).abs().max()
                         .item() / scale)
        worst_jax = max(worst_jax, (gj[k].double() - want).abs().max()
                        .item() / scale)
    assert worst_port < 1e-4, worst_port
    assert worst_jax < 2e-2, worst_jax


@contextmanager
def _float64_batch_norm():
    """The port's BatchNorm without its float32 cast, so a float64 model
    stays float64."""
    from drn_wsod_torch.models.backbones import resnet_ws

    forward = resnet_ws.BatchNorm.forward

    def forward64(self, x):
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])
    resnet_ws.BatchNorm.forward = forward64
    try:
        yield
    finally:
        resnet_ws.BatchNorm.forward = forward
