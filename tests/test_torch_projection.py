"""PyTorch port, preprocess: `langsplat_tpu_torch.ops.projection.preprocess` against the
JAX `preprocess` on the same numpy inputs.

Integer and boolean outputs (radii, tile rects, visibility) must match exactly; float
outputs within 1e-5 absolute / relative (float32, different reduction order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.ops import projection as jproj
from langsplat_tpu_torch.ops import projection as tproj

from tests.test_projection_and_dense import make_camera
from tests.test_tiles import random_scene

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

FLOAT_TOL = dict(atol=1e-5, rtol=1e-5)


def torch_camera(cam):
    """The JAX test camera's matrices as torch tensors."""
    return {k: (torch.tensor(np.asarray(v)) if k in ("viewmatrix", "projmatrix",
                                                       "campos") else v)
            for k, v in cam.items()}


def both_preprocess(cam, means, scales, quats, *, shs=None, sh_degree=0, tile_size=16,
                    colors=None, cov3d=None, alive=None):
    """Run the JAX and the port's preprocess on the same numpy inputs."""
    kw = dict(image_height=cam["image_height"], image_width=cam["image_width"],
              tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"], sh_degree=sh_degree,
              tile_size=tile_size)
    opt = dict(colors_precomp=colors, cov3d_precomp=cov3d, alive=alive)
    j = jproj.preprocess(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        None if shs is None else jnp.asarray(shs),
        cam["viewmatrix"], cam["projmatrix"], cam["campos"], **kw,
        **{k: None if v is None else jnp.asarray(v) for k, v in opt.items()})
    tc = torch_camera(cam)
    t = tproj.preprocess(
        torch.tensor(means), torch.tensor(scales), torch.tensor(quats),
        None if shs is None else torch.tensor(shs),
        tc["viewmatrix"], tc["projmatrix"], tc["campos"], **kw,
        **{k: None if v is None else torch.tensor(v) for k, v in opt.items()})
    return j, t


def assert_prep_match(j, t):
    for name in ("radii", "tiles_min", "tiles_max", "visible"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    assert t.radii.dtype == torch.int32 and t.tiles_min.dtype == torch.int32
    for name in ("means2d", "depths", "conics", "colors"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), err_msg=name,
                                   **FLOAT_TOL)


def rotated_camera(w=64, h=48, fov=0.9):
    """A camera with a generic rotation and translation (not axis-aligned)."""
    from langsplat_tpu.core import transforms
    from langsplat_tpu.data.colmap import qvec_to_rotmat
    q = np.array([0.98, 0.1, -0.15, 0.05])
    R = qvec_to_rotmat(q / np.linalg.norm(q))
    view = transforms.world_to_view(R, np.array([0.2, -0.1, 0.5])).T
    proj = transforms.projection_matrix(0.01, 100.0, fov, fov * h / w).T
    return dict(viewmatrix=jnp.asarray(view), projmatrix=jnp.asarray(view @ proj),
                campos=jnp.asarray(np.linalg.inv(view)[3, :3]), image_width=w,
                image_height=h, tanfovx=float(np.tan(fov / 2)),
                tanfovy=float(np.tan(fov * h / w / 2)))


@pytest.mark.parametrize("sh_degree", [0, 1, 2, 3])
def test_preprocess_sh_matches_jax(sh_degree):
    cam = rotated_camera()
    means, scales, quats, _, _, _ = random_scene(150, seed=20 + sh_degree)
    shs = np.random.default_rng(sh_degree).normal(
        size=(150, 16, 3)).astype(np.float32) * 0.5
    j, t = both_preprocess(cam, means, scales, quats, shs=shs, sh_degree=sh_degree)
    assert int(np.asarray(j.visible).sum()) > 50
    assert_prep_match(j, t)


def test_preprocess_alive_mask_and_precomputed_matches_jax():
    cam = make_camera(w=64, h=48)
    means, scales, quats, colors, _, _ = random_scene(120, seed=31)
    alive = np.random.default_rng(3).uniform(size=120) < 0.7
    from langsplat_tpu.core import transforms
    cov = np.asarray(transforms.strip_symmetric(transforms.build_covariance_3d(
        jnp.asarray(scales), jnp.asarray(quats))))
    j, t = both_preprocess(cam, means, scales, quats, colors=colors, cov3d=cov,
                           alive=alive)
    assert not np.asarray(j.visible)[~alive].any()
    assert_prep_match(j, t)


def test_preprocess_behind_camera_and_odd_tiles_match_jax():
    """Points behind the near plane and close to it, off-screen points, and an image
    whose size is not a multiple of the tile size."""
    cam = make_camera(w=50, h=37, z_offset=-1.0)
    rng = np.random.default_rng(5)
    means = np.concatenate([rng.uniform(-4, 4, (200, 2)),
                            rng.uniform(-3, 6, (200, 1))], axis=1).astype(np.float32)
    scales = np.exp(rng.uniform(-3, 0, (200, 3))).astype(np.float32)
    quats = rng.normal(size=(200, 4)).astype(np.float32)
    colors = rng.uniform(size=(200, 3)).astype(np.float32)
    j, t = both_preprocess(cam, means, scales, quats, colors=colors, tile_size=8)
    assert not np.asarray(j.visible).all() and np.asarray(j.visible).any()
    assert_prep_match(j, t)


# ---------------------------------------------------------------------------
# Dispatch: CPU tensors take the plain version; the kernels' input checks
# ---------------------------------------------------------------------------

def port_inputs(n=120, seed=40, sh_degree=3, precomputed=False, grad=False):
    """The port's preprocess arguments for a random scene before the rotated camera."""
    from langsplat_tpu_torch.core import transforms as ttf
    cam = torch_camera(rotated_camera())
    means, scales, quats, colors, _, _ = random_scene(n, seed=seed)
    shs = np.random.default_rng(seed).normal(size=(n, 16, 3)).astype(np.float32) * 0.5
    kw = {k: torch.tensor(v, requires_grad=grad) for k, v in
          dict(means3d=means, scales=scales, quats=quats, shs=shs).items()}
    if precomputed:
        cov = ttf.strip_symmetric(ttf.build_covariance_3d(
            torch.tensor(scales), torch.tensor(quats)))
        kw["cov3d_precomp"] = cov.detach().requires_grad_(grad)
        kw["colors_precomp"] = torch.tensor(colors, requires_grad=grad)
        kw["alive"] = torch.tensor(np.random.default_rng(seed).uniform(size=n) < 0.7)
    kw.update({k: cam[k] for k in ("viewmatrix", "projmatrix", "campos")})
    kw.update(image_height=cam["image_height"], image_width=cam["image_width"],
              tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"], sh_degree=sh_degree,
              tile_size=16)
    return kw


def run_port(fn, kw):
    kw = dict(kw)
    args = [kw.pop(k) for k in ("means3d", "scales", "quats", "shs", "viewmatrix",
                                "projmatrix", "campos")]
    return fn(*args, **kw)


@pytest.mark.parametrize("sh_degree,precomputed", [(0, False), (3, False), (1, True)])
def test_preprocess_on_cpu_is_the_plain_version(monkeypatch, sh_degree, precomputed):
    """CPU tensors never reach the kernels' build (no launch counted), and preprocess's
    outputs and gradients are the plain version's, bit for bit."""
    from langsplat_tpu_torch.ops import _build

    def no_build(source):
        raise AssertionError(f"{source} built for CPU tensors")
    monkeypatch.setattr(_build, "load", no_build)
    kw = port_inputs(sh_degree=sh_degree, precomputed=precomputed, grad=True)
    launches = dict(_build.LAUNCHES)
    outs = [run_port(fn, kw) for fn in (tproj.preprocess, tproj.preprocess_plain)]
    assert dict(_build.LAUNCHES) == launches
    leaves = [kw[k] for k in ("means3d", "scales", "quats", "shs", "cov3d_precomp",
                              "colors_precomp") if k in kw]
    weights = [torch.randn(outs[0].means2d.shape[0], 3, generator=torch.Generator()
                           .manual_seed(i)) for i in range(4)]
    grads = []
    for out in outs:
        for name in tproj.PreprocessOut._fields:
            assert getattr(out, name).dtype == getattr(outs[1], name).dtype
        loss = ((out.means2d * weights[0][:, :2]).sum() + (out.depths * weights[1][:, 0]).sum()
                + (out.conics * weights[2]).sum() + (out.colors * weights[3]).sum())
        grads.append(torch.autograd.grad(loss, leaves, allow_unused=True))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(*grads):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


def test_kernel_input_checks():
    """What the kernels refuse, checked before a launch (the check runs on any device):
    a non-contiguous or float64 input, a camera that requires grad, more or fewer SH
    coefficients than the kernels take, an alive mask that is not bool. A camera of
    other strides is read through them."""
    kw = port_inputs()

    def check(**over):
        k = dict(kw, **over)
        tproj.check_kernel_inputs(
            k["means3d"], k["scales"], k["quats"], k["shs"], k["viewmatrix"],
            k["projmatrix"], k["campos"], sh_degree=k["sh_degree"],
            tile_size=k["tile_size"], alive=k.get("alive"))

    check()
    check(viewmatrix=kw["viewmatrix"].T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        check(means3d=kw["means3d"].T.contiguous().T)
    with pytest.raises(ValueError, match="dtype"):
        check(quats=kw["quats"].double())
    with pytest.raises(ValueError, match="requires grad"):
        check(projmatrix=kw["projmatrix"].clone().requires_grad_(True))
    with pytest.raises(ValueError, match="coefficients"):
        check(sh_degree=4)
    with pytest.raises(ValueError, match="coefficients"):
        check(shs=torch.zeros((120, tproj.MAX_COEFFS + 1, 3)), sh_degree=4)
    with pytest.raises(ValueError, match="dtype"):
        check(alive=torch.ones(120, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        run_port(tproj.preprocess_cuda, kw)
