"""PyTorch port, losses and the k-NN scale initialisation against the JAX package:
L1, L2, PSNR, separable SSIM (value and gradient), the phase-A RGB loss and the
phase-B masked L1 to 1e-6; the SSIM backward kernel's formula (`csrc/ssim.cu`) against
autograd and jax.grad; `mean_knn_sq_dist` to 1e-5 relative."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.core import losses as jlosses
from langsplat_tpu.ops.knn import mean_knn_sq_dist as jax_knn
from langsplat_tpu_torch.core import losses as tlosses
from langsplat_tpu_torch.ops.knn import mean_knn_sq_dist

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 1e-6


def images(seed, shape=(3, 48, 64)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "psnr", "ssim", "rgb_loss"])
@pytest.mark.parametrize("shape", [(3, 48, 64), (2, 3, 20, 33)])
def test_loss_matches_jax(name, shape):
    a, b = images(1, shape)
    got = getattr(tlosses, name)(torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)


def test_ssim_gradient_matches_jax():
    a, b = images(2)
    ta = torch.tensor(a, requires_grad=True)
    tlosses.rgb_loss(ta, torch.tensor(b)).backward()
    ja = jax.grad(lambda x: jlosses.rgb_loss(x, jnp.asarray(b)))(jnp.asarray(a))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), atol=ATOL)


def test_ssim_of_identical_images_is_one():
    a, _ = images(3)
    np.testing.assert_allclose(float(tlosses.ssim(torch.tensor(a), torch.tensor(a))), 1.0,
                               atol=ATOL)


def ssim_grad_by_formula(x, y, window_size=11, sigma=1.5):
    """dSSIM/dx as the SSIM kernels compute it: the forward's three derivative maps
    (dS/dmu1 with the sigma terms' chain folded in, dS/dE[x^2], dS/dE[xy]) blurred with
    the window, its own adjoint, and combined at each pixel, over the element count."""
    window = tlosses._gaussian_window(window_size, sigma)

    def blur(t):
        return tlosses._depthwise_blur(t, window)
    c1, c2 = tlosses.C1, tlosses.C2
    mu1, mu2 = blur(x), blur(y)
    sigma1_sq = blur(x * x) - mu1 * mu1
    sigma2_sq = blur(y * y) - mu2 * mu2
    sigma12 = blur(x * y) - mu1 * mu2
    a1, a2 = 2 * mu1 * mu2 + c1, 2 * sigma12 + c2
    b1, b2 = mu1 * mu1 + mu2 * mu2 + c1, sigma1_sq + sigma2_sq + c2
    den = b1 * b2
    s = a1 * a2 / den
    d_mu = 2 / den * (mu2 * (a2 - a1) - mu1 * s * (b2 - b1))
    d_e11 = -s / b2
    d_e12 = 2 * a1 / den
    return (blur(d_mu) + 2 * x * blur(d_e11) + y * blur(d_e12)) / x.numel()


@pytest.mark.parametrize("seed,shape", [(11, (3, 48, 64)), (12, (3, 37, 29)),
                                        (13, (2, 3, 20, 33))])
def test_ssim_backward_formula_matches_autograd_and_jax(seed, shape):
    """The formula of the SSIM backward kernel, in plain torch: exact to float64
    rounding against autograd of `ssim` in float64, and in float32 within 1e-5 of the
    largest magnitude of autograd's and jax.grad's gradients."""
    a, b = images(seed, shape)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        x = torch.tensor(a, dtype=dtype, requires_grad=True)
        y = torch.tensor(b, dtype=dtype)
        (want,) = torch.autograd.grad(tlosses.ssim(x, y), [x])
        got = ssim_grad_by_formula(x.detach(), y)
        scale = float(want.abs().max())
        assert scale > 0
        assert float((got - want).abs().max()) <= tol * scale, dtype
    ja = np.asarray(jax.grad(lambda v: jlosses.ssim(v, jnp.asarray(b)))(jnp.asarray(a)))
    np.testing.assert_allclose(got.numpy(), ja, rtol=0, atol=1e-5 * np.abs(ja).max())


def test_masked_l1_matches_jax():
    a, b = images(4)
    mask = (np.random.default_rng(5).uniform(size=(1, 48, 64)) < 0.6).astype(np.float32)
    got = float(tlosses.masked_l1_loss(torch.tensor(a), torch.tensor(b),
                                       torch.tensor(mask)))
    want = float(jlosses.masked_l1_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n,chunk", [(200, 1024), (200, 64), (37, 8)])
def test_knn_matches_jax(n, chunk):
    pts = np.random.default_rng(n).uniform(-1, 1, (n, 3)).astype(np.float32)
    got = mean_knn_sq_dist(torch.tensor(pts), chunk=chunk).numpy()
    want = np.asarray(jax_knn(jnp.asarray(pts)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # and against a direct computation
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    np.testing.assert_allclose(got, np.sort(d2, axis=1)[:, :3].mean(1), rtol=1e-4)
