"""PyTorch port, core math: SH evaluation and transforms against the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.core import sh as jsh
from langsplat_tpu.core import transforms as jtf
from langsplat_tpu_torch.core import sh as tsh
from langsplat_tpu_torch.core import transforms as ttf

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

RTOL = 1e-6   # same float32 expressions in the same order; only rounding may differ
ATOL = 1e-6


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_eval_sh_matches_jax(degree):
    rng = np.random.default_rng(degree)
    sh = rng.normal(size=(64, 3, 25)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    close(tsh.eval_sh(degree, torch.from_numpy(sh), torch.from_numpy(dirs)),
          jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(dirs)))
    close(tsh.sh_to_color(degree, torch.from_numpy(sh), torch.from_numpy(dirs)),
          jsh.sh_to_color(degree, jnp.asarray(sh), jnp.asarray(dirs)))


def test_rgb_to_sh_and_degree_check():
    rgb = np.random.default_rng(0).uniform(size=(10, 3)).astype(np.float32)
    close(tsh.rgb_to_sh(torch.from_numpy(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)))
    with pytest.raises(ValueError):
        tsh.eval_sh(5, torch.zeros(1, 3, 36), torch.zeros(1, 3))


def test_covariance_and_rotation_match_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    s = np.exp(rng.uniform(-3, 0, (50, 3))).astype(np.float32)
    close(ttf.quat_to_rotmat(torch.from_numpy(q)), jtf.quat_to_rotmat(jnp.asarray(q)))
    cov_t = ttf.build_covariance_3d(torch.from_numpy(s), torch.from_numpy(q), 0.7)
    cov_j = jtf.build_covariance_3d(jnp.asarray(s), jnp.asarray(q), 0.7)
    close(cov_t, cov_j)
    c6 = ttf.strip_symmetric(cov_t)
    close(c6, jtf.strip_symmetric(cov_j))
    close(ttf.unstrip_symmetric(c6), jtf.unstrip_symmetric(jnp.asarray(c6.numpy())))


def test_camera_matrices_match_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    from langsplat_tpu.data.colmap import qvec_to_rotmat
    R = qvec_to_rotmat(q)
    t = rng.normal(size=3)
    for translate, scale in [(None, 1.0), (np.array([0.1, -0.2, 0.3]), 1.5)]:
        np.testing.assert_array_equal(ttf.world_to_view(R, t, translate, scale),
                                      jtf.world_to_view(R, t, translate, scale))
    np.testing.assert_array_equal(ttf.projection_matrix(0.01, 100.0, 0.9, 0.7),
                                  jtf.projection_matrix(0.01, 100.0, 0.9, 0.7))
    assert ttf.fov_to_focal(0.8, 640) == jtf.fov_to_focal(0.8, 640)
    assert ttf.focal_to_fov(500.0, 640) == jtf.focal_to_fov(500.0, 640)
