"""Training losses of the PyTorch port against ibgs_tpu.train.losses.

Each loss and its gradient w.r.t. its image inputs, on the same numpy
inputs at odd sizes (so the 11-tap blur's zero padding reaches every
edge), float32 on both sides.  Tolerance 1e-5 (rtol and atol; gradients
atol 1e-5 x their largest value): the port blurs with the same
shift-and-add order, H pass then W pass; only the final means sum in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibgs_tpu.train import losses as jl
from ibgs_tpu_torch.train import losses as tl
from tests.test_torch_slice import one_torch_thread  # noqa: F401

H, W, S = 23, 37, 3


def _images(seed, shape=(H, W, 3)):
    r = np.random.default_rng(seed)
    a = r.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + r.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


def _check(jfn, tfn, *arrays, grad_args=(0, 1)):
    want, jgrads = jax.value_and_grad(jfn, argnums=grad_args)(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.as_tensor(a).requires_grad_(i in grad_args)
          for i, a in enumerate(arrays)]
    got = tfn(*ts)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-5)
    tgrads = torch.autograd.grad(got, [ts[i] for i in grad_args])
    for g, w in zip(tgrads, jgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("name", ["l1", "l2", "psnr", "ssim", "dssim_l1"])
def test_image_losses(name):
    a, b = _images(0)
    _check(getattr(jl, name), getattr(tl, name), a, b)


def test_ssim_map_and_photometric_ssim():
    a, b = _images(1)
    np.testing.assert_allclose(
        tl.ssim_map(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jl.ssim_map(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    _check(lambda x, y: jl.photometric_ssim(x, y).sum(),
           lambda x, y: tl.photometric_ssim(x, y).sum(), a, b)


def test_normal_consistency():
    r = np.random.default_rng(2)
    n1 = r.normal(size=(H, W, 3)).astype(np.float32)
    n2 = r.normal(size=(H, W, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=-1, keepdims=True)
    _check(lambda x, y: jl.normal_consistency(x, y, 0.03),
           lambda x, y: tl.normal_consistency(x, y, 0.03), n1, n2)


@pytest.mark.parametrize("valid_share", [0.6, 0.0])
def test_multi_view_photometric(valid_share):
    gt, _ = _images(3)
    warped = np.stack([_images(4 + s)[1] for s in range(S)])
    valid = np.random.default_rng(9).uniform(size=(S, H, W)) < valid_share
    _check(lambda g, w, v: jl.multi_view_photometric(g, w, v, 1.0, 0.3),
           lambda g, w, v: tl.multi_view_photometric(g, w, v, 1.0, 0.3),
           gt, warped, valid)
    _check(lambda g, w, v: jl.multi_view_photometric(g, w, v, 0.2, 0.3),
           lambda g, w, v: tl.multi_view_photometric(g, w, v, 0.2, 0.3),
           gt, warped, valid)
