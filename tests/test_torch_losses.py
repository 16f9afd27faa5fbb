"""PyTorch port, losses and the k-NN scale initialisation against the JAX package:
L1, L2, PSNR, separable SSIM (value and gradient), the phase-A RGB loss and the
phase-B masked L1 to 1e-6; `mean_knn_sq_dist` to 1e-5 relative."""

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
