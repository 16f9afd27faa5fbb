"""PyTorch port, whole render: `langsplat_tpu_torch.ops.render.render` against the JAX
`render` on the same field, at sh_degree 3 with language features, black and white
backgrounds, within 3e-5 absolute (the JAX package's Pallas-vs-dense tolerance)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.models.gaussian_field import GaussianField as JaxField
from langsplat_tpu.ops import render as jrender
from langsplat_tpu_torch.models.gaussian_field import from_numpy
from langsplat_tpu_torch.ops import render as trender

from tests.test_projection_and_dense import make_camera

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 3e-5
W, H = 64, 48
jax_render = jax.jit(jrender.render, static_argnames=("settings",))


def field_params(n=140, cap=160, seed=0, sh_degree=3, num_feat=3):
    """Leaves of a trained-looking field (numpy), with dead capacity slots."""
    rng = np.random.default_rng(seed)
    k = (sh_degree + 1) ** 2
    xyz = np.concatenate([rng.uniform(-2, 2, (cap, 2)), rng.uniform(3, 9, (cap, 1))],
                         axis=1)
    alive = np.zeros(cap, bool)
    alive[:n] = True
    alive[rng.choice(n, 10, replace=False)] = False
    params = dict(
        xyz=xyz, features_dc=rng.normal(size=(cap, 1, 3)),
        features_rest=0.3 * rng.normal(size=(cap, k - 1, 3)),
        scaling=np.log(rng.uniform(0.05, 0.5, (cap, 3))),
        rotation=rng.normal(size=(cap, 4)), opacity=rng.normal(size=(cap, 1)),
        language_feature=rng.normal(size=(cap, num_feat)) if num_feat else None)
    params = {k: None if v is None else v.astype(np.float32) for k, v in params.items()}
    params["alive"] = alive
    return params


def jax_field(params):
    return JaxField(**{k: None if v is None else jnp.asarray(v) for k, v in params.items()})


def cam_tensors(cam):
    return [torch.tensor(np.asarray(cam[k])) for k in ("viewmatrix", "projmatrix",
                                                       "campos")]


@pytest.mark.parametrize("bg,include_feature", [
    ([0.0, 0.0, 0.0], True), ([1.0, 1.0, 1.0], True), ([1.0, 1.0, 1.0], False)])
def test_render_matches_jax(bg, include_feature):
    """Against the JAX render on its tiled backend (the blend itself is held against
    the Pallas kernel in test_torch_rasterize.py)."""
    params = field_params()
    cam = make_camera(w=W, h=H)
    common = dict(image_height=H, image_width=W, tanfovx=cam["tanfovx"],
                  tanfovy=cam["tanfovy"], sh_degree=3, include_feature=include_feature)
    jout = jax_render(
        jax_field(params),
        jrender.RenderSettings(**common, backend="tiled", max_per_tile=512),
        cam["viewmatrix"], cam["projmatrix"], cam["campos"], jnp.asarray(bg))
    tout = trender.render(from_numpy(params, "cpu"), trender.RenderSettings(**common),
                          *cam_tensors(cam), torch.tensor(bg))
    for k in ("render", "final_transmittance", "language_feature_image"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=ATOL,
                                   err_msg=k)
    for k in ("radii", "visibility_filter", "instances_dropped", "rect_dropped"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    assert int(tout["visibility_filter"].sum()) > 50


def test_python_escape_hatches_and_count_match_jax():
    """convert_SHs_python / compute_cov3D_python give the same image, and the count
    probe equals the JAX one."""
    params = field_params(seed=1)
    cam = make_camera(w=W, h=H)
    field = from_numpy(params, "cpu")
    mats = cam_tensors(cam)
    base = trender.RenderSettings(image_height=H, image_width=W, tanfovx=cam["tanfovx"],
                                  tanfovy=cam["tanfovy"], sh_degree=3)
    plain = trender.render(field, base, *mats, torch.zeros(3))
    hatch = trender.render(field, trender.RenderSettings(
        **{**base.__dict__, "convert_shs_python": True, "compute_cov3d_python": True}),
        *mats, torch.zeros(3))
    for k in ("render", "language_feature_image"):
        torch.testing.assert_close(hatch[k], plain[k], atol=1e-6, rtol=0)
    jcount = jrender.count_instances(
        jax_field(params), jrender.RenderSettings(
            image_height=H, image_width=W, tanfovx=cam["tanfovx"],
            tanfovy=cam["tanfovy"], sh_degree=3),
        cam["viewmatrix"], cam["projmatrix"], cam["campos"])
    assert trender.count_instances(field, base, *mats) == int(jcount) > 0
