"""The port's dense CRF (``drn_wsod_torch/ops/crf.py``) against the JAX
package's ``ops/crf.py``, on the CPU, on seeded (H, W, L) probabilities and
u8 images: the port takes a batch of images at once, JAX one image.

Tolerances (float32; the convolutions, the window sums' fused products and
the softmax round differently): the Gaussian taps within 1 float32 ulp;
the spatial and bilateral messages, and ``crf_forward`` after one
iteration, within atol 2e-6 (values up to 1); ``crf_inference`` (5
iterations) within atol 2e-5; ``crf_forward`` at its default 10 iterations
within atol 2e-4. Its mean-field map amplifies a rounding difference where
two labels nearly tie: on this fixture the largest difference is 4e-7
after one iteration and grows about 1.7x an iteration, to 7.6e-5 after
ten, at 4 of 16128 values."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drn_wsod_torch.ops import crf as port
from drn_wsod_tpu.ops import crf as ref

torch.set_num_threads(1)

MSG_ATOL, CRF_ATOL, CRF10_ATOL = 2e-6, 2e-5, 2e-4


def _case(H, W, L, seed=0, B=2):
    rs = np.random.RandomState(seed)
    probs = rs.dirichlet(np.full(L, 0.3), size=(B, H, W)).astype(np.float32)
    # smooth blobs of colour with noise: edges for the bilateral kernel
    base = rs.randint(0, 256, (B, H // 6 + 1, W // 6 + 1, 3))
    img = np.repeat(np.repeat(base, 6, 1), 6, 2)[:, :H, :W]
    img = np.clip(img + rs.randint(-8, 9, img.shape), 0, 255).astype(np.uint8)
    return probs, img


def test_gaussian_kernel1d():
    for sigma, radius in ((1.2, 3), (3.0, 5), (0.7, 1)):
        want = np.asarray(ref._gaussian_kernel1d(sigma, radius))
        got = port._gaussian_kernel1d(sigma, radius).numpy()
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


@pytest.mark.parametrize("normalize", ["pixel", "sym"])
def test_spatial_message(normalize):
    q, _ = _case(19, 26, 5, seed=1)
    got = port._spatial_message(torch.from_numpy(q), 1.7, 3, normalize)
    for b in range(2):
        want = np.asarray(ref._spatial_message(jnp.asarray(q[b]), 1.7, 3,
                                               normalize))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0,
                                   atol=MSG_ATOL)


@functools.lru_cache(maxsize=None)
def _jax_bilateral(normalize, stride, radius):
    return jax.jit(functools.partial(
        ref._bilateral_message, sigma_spatial=6.0, sigma_color=13.0,
        radius=radius, normalize=normalize, stride=stride))


@pytest.mark.parametrize("stride,radius", [(1, 3), (3, 2)])
@pytest.mark.parametrize("normalize", ["pixel", "sym"])
def test_bilateral_message(normalize, stride, radius):
    q, img = _case(17, 23, 4, seed=2)
    got = port._bilateral_message(torch.from_numpy(q), torch.from_numpy(img),
                                  6.0, 13.0, radius, normalize, stride)
    for b in range(2):
        want = np.asarray(_jax_bilateral(normalize, stride, radius)(
            jnp.asarray(q[b]), jnp.asarray(img[b])))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0,
                                   atol=MSG_ATOL)


@pytest.mark.parametrize("max_iter,atol", [(10, CRF10_ATOL), (1, MSG_ATOL)],
                         ids=["defaults", "one_iteration"])
def test_crf_forward_non_square_21_labels(max_iter, atol):
    """The defaults (radius 4, taps spaced round(sigma / 2) apart: stride
    2 at this size) on a 24x32 map of 21 labels, at 10 iterations and at
    one."""
    probs, img = _case(24, 32, 21, seed=3)
    got = port.crf_forward(torch.from_numpy(probs), torch.from_numpy(img),
                           max_iter=max_iter)
    assert got.shape == probs.shape
    for b in range(2):
        want = np.asarray(ref.crf_forward(jnp.asarray(probs[b]),
                                          jnp.asarray(img[b]),
                                          max_iter=max_iter))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_crf_forward_square_few_labels():
    """A square 20x20 map of 3 labels, 3 iterations, radius 2, and a
    larger size_std (the bilateral sigma shrinks: stride 1)."""
    probs, img = _case(20, 20, 3, seed=4)
    kw = dict(max_iter=3, bilateral_radius=2, size_std=1000.0)
    got = port.crf_forward(torch.from_numpy(probs), torch.from_numpy(img),
                           **kw)
    for b in range(2):
        want = np.asarray(ref.crf_forward(jnp.asarray(probs[b]),
                                          jnp.asarray(img[b]), **kw))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0,
                                   atol=CRF_ATOL)


@pytest.mark.parametrize("downsample", [2, 1])
def test_crf_inference(downsample):
    probs, img = _case(22, 30, 6, seed=5)
    got = port.crf_inference(torch.from_numpy(probs), torch.from_numpy(img),
                             downsample=downsample)
    for b in range(2):
        want = np.asarray(ref.crf_inference(
            jnp.asarray(probs[b]), jnp.asarray(img[b]),
            downsample=downsample))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0,
                                   atol=CRF_ATOL)
