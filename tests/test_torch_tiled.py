"""PyTorch port, tiled backend (`ops/rasterize_tiled.py`): the forward against the JAX
package's `rasterize_tiled` (3e-5), including tiles that overflow `max_per_tile`;
gradients through the preprocess and the screen-space tap against JAX autodiff of the
same render (5e-5); the backward bit-equal over two runs and reduced through
`segment_sum`; on tiles that are not truncated, the same image as the port's plain
blend; and `render` with `backend="tiled"` against the JAX package's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.ops import projection as jproj
from langsplat_tpu.ops.rasterize_tiled import rasterize_tiled as jax_rasterize_tiled
from langsplat_tpu.ops.tiles import bin_gaussians as jax_bin_gaussians
from langsplat_tpu_torch.ops import _build, projection, rasterize_cuda, tiles
from langsplat_tpu_torch.ops.rasterize_tiled import rasterize_tiled, truncated_tiles

from tests.test_projection_and_dense import make_camera
from tests.test_tiles import random_scene
from tests.test_torch_blend_bwd import loss_of, targets
from tests.test_torch_rasterize import jax_scene, to_torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 3e-5
GRAD_ATOL = 5e-5
KEYS = ("render", "final_transmittance", "language_feature_image")

# name -> (scene of tests/test_torch_rasterize.jax_scene, bg, max_per_tile, truncates)
FORWARD = {
    "whole": (dict(n=120, seed=3, w=64, h=48, budget=8192, tmax=64), [0.1, 0.3, 1.0],
              1024, False),
    "overflow": (dict(n=120, seed=3, w=64, h=48, budget=8192, tmax=64), [0.1, 0.3, 1.0],
                 48, True),
    "odd_tiles": (dict(n=60, seed=13, w=48, h=16, budget=2048, tmax=16), [0.5, 0.1, 0.2],
                  16, True),
}

# name -> (n, seed, spread, w, h, budget, tmax, num_feat, grad_mode, bg, max_per_tile)
GRADS = {
    "full": (40, 7, 1.0, 32, 32, 2048, 16, 3, "full", [0.2, 0.5, 0.8], 1024),
    "rgb_only_overflow": (60, 13, 2.0, 48, 16, 2048, 16, 0, "full", [0.5, 0.1, 0.2], 12),
    "full_overflow": (120, 3, 2.0, 64, 48, 8192, 64, 3, "full", [0.1, 0.3, 1.0], 40),
    "feature_overflow": (120, 3, 2.0, 64, 48, 8192, 64, 3, "feature", [0.0, 0.0, 0.0],
                         40),
}
NAMES = ("means", "scales", "opac", "colors", "feats", "tap")
# compiled once per case: run eagerly, its vmapped ops compile one by one (~4 s a call)
jax_tiled = jax.jit(jax_rasterize_tiled, static_argnames=(
    "image_height", "image_width", "tile_size", "max_per_tile"))


def port_tiled(tprep, tinst, opac, feats, bg, w, h, max_per_tile):
    return rasterize_tiled(tprep, tinst, torch.tensor(opac),
                           None if feats is None else torch.tensor(feats),
                           torch.tensor(bg, dtype=torch.float32), image_height=h,
                           image_width=w, tile_size=16, max_per_tile=max_per_tile)


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_tiled_forward_matches_jax(name):
    scene, bg, max_per_tile, truncates = FORWARD[name]
    prep, inst, opac, feats = jax_scene(**scene)
    w, h = scene["w"], scene["h"]
    want = jax_tiled(prep, inst, jnp.asarray(opac), jnp.asarray(feats), jnp.asarray(bg),
                     image_height=h, image_width=w, tile_size=16,
                     max_per_tile=max_per_tile)
    tprep, tinst = to_torch(prep, inst)
    assert (truncated_tiles(tinst, max_per_tile) > 0) == truncates
    launches = dict(_build.LAUNCHES)
    got = port_tiled(tprep, tinst, opac, feats, bg, w, h, max_per_tile)
    assert _build.LAUNCHES == launches          # no kernel of its own
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL,
                                   err_msg=k)


def test_tiled_equals_the_plain_blend_on_untruncated_tiles():
    """The overflowing scene: tiles within max_per_tile render as the port's plain
    blend (which never truncates) renders them; the truncated ones differ."""
    scene, bg, max_per_tile, _ = FORWARD["overflow"]
    prep, inst, opac, feats = jax_scene(**scene)
    w, h = scene["w"], scene["h"]
    tprep, tinst = to_torch(prep, inst)
    got = port_tiled(tprep, tinst, opac, feats, bg, w, h, max_per_tile)
    plain = rasterize_cuda.rasterize(tprep, tinst, torch.tensor(opac), torch.tensor(feats),
                                     torch.tensor(bg, dtype=torch.float32),
                                     image_height=h, image_width=w, tile_size=16)
    counts = (tinst.tile_start[1:] - tinst.tile_start[:-1]).reshape(-(-h // 16),
                                                                    -(-w // 16))
    whole = (counts <= max_per_tile).repeat_interleave(16, 0).repeat_interleave(16, 1)
    whole = whole[:h, :w]
    assert 0 < int(whole.sum()) < h * w
    for k in KEYS:
        diff = (got[k] - plain[k]).abs()
        diff = diff if diff.dim() == 3 else diff[None]
        assert float(diff[:, whole].max()) <= ATOL, k
        assert float(diff[:, ~whole].max()) > 1e-3, k


def jax_tiled_grads(name):
    n, seed, spread, w, h, budget, tmax, num_feat, grad_mode, bg, mpt = GRADS[name]
    cam = make_camera(w=w, h=h)
    means, scales, quats, colors, opac, feats = random_scene(n, seed=seed, spread=spread)
    target, ftarget = targets(w, h)

    def loss_fn(means3d, scales_, opac_, colors_, feats_, tap):
        prep = jproj.preprocess(
            means3d, scales_, jnp.asarray(quats), None, cam["viewmatrix"],
            cam["projmatrix"], cam["campos"], image_height=h, image_width=w,
            tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"], sh_degree=0, tile_size=16,
            colors_precomp=colors_)
        inst = jax_bin_gaussians(jax.tree.map(jax.lax.stop_gradient, prep),
                                 grid_x=-(-w // 16), grid_y=-(-h // 16), budget=budget,
                                 max_tiles_per_gaussian=tmax)
        out = jax_rasterize_tiled(prep._replace(means2d=prep.means2d + tap), inst, opac_,
                                  feats_ if num_feat else None, jnp.asarray(bg),
                                  image_height=h, image_width=w, tile_size=16,
                                  max_per_tile=mpt)
        return loss_of(out, target, ftarget, num_feat, grad_mode, jnp)

    args = [jnp.asarray(x) for x in (means, scales, opac, colors, feats)]
    args.append(jnp.zeros((n, 2), jnp.float32))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn, argnums=tuple(range(6))))(*args)
    return float(loss), [np.asarray(g) for g in grads]


def port_tiled_loss(name):
    """(loss, leaves, instances truncated) of the port's tiled render of scene `name`."""
    n, seed, spread, w, h, budget, tmax, num_feat, grad_mode, bg, mpt = GRADS[name]
    cam = make_camera(w=w, h=h)
    means, scales, quats, colors, opac, feats = random_scene(n, seed=seed, spread=spread)
    target, ftarget = targets(w, h)
    leaves = [torch.tensor(x, requires_grad=True)
              for x in (means, scales, opac, colors, feats)]
    leaves.append(torch.zeros((n, 2), requires_grad=True))
    means_t, scales_t, opac_t, colors_t, feats_t, tap = leaves
    mats = [torch.tensor(np.asarray(cam[k])) for k in ("viewmatrix", "projmatrix", "campos")]
    prep = projection.preprocess(
        means_t, scales_t, torch.tensor(quats), None, *mats, image_height=h,
        image_width=w, tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"], sh_degree=0,
        tile_size=16, colors_precomp=colors_t)
    inst = tiles.bin_gaussians(projection.PreprocessOut(*(t.detach() for t in prep)),
                               grid_x=-(-w // 16), grid_y=-(-h // 16), budget=budget,
                               max_tiles_per_gaussian=tmax)
    out = rasterize_tiled(prep, inst, opac_t, feats_t if num_feat else None,
                          torch.tensor(bg), image_height=h, image_width=w, tile_size=16,
                          max_per_tile=mpt, means2d_override=prep.means2d + tap,
                          grad_mode=grad_mode)
    loss = loss_of(out, torch.tensor(target), torch.tensor(ftarget), num_feat, grad_mode,
                   torch)
    return loss, leaves, truncated_tiles(inst, mpt)


@pytest.mark.parametrize("name", sorted(GRADS))
def test_tiled_gradients_match_jax(name, monkeypatch):
    num_feat, grad_mode = GRADS[name][7], GRADS[name][8]
    jloss, jgrads = jax_tiled_grads(name)
    sums = []

    def counted(d_pre, ends, n_out):
        sums.append(d_pre.shape)
        return segment_sum(d_pre, ends, n_out)

    segment_sum = rasterize_cuda.segment_sum
    monkeypatch.setattr(rasterize_cuda, "segment_sum", counted)
    loss, leaves, truncated = port_tiled_loss(name)
    assert (truncated > 0) == name.endswith("overflow")
    loss.backward()
    assert len(sums) == 1           # the per-instance rows went through one segment sum
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    for nm, leaf, jg in zip(NAMES, leaves, jgrads):
        if grad_mode == "feature" and nm != "feats" or nm == "feats" and not num_feat:
            # grad mode "feature" yields only feature gradients; JAX's tiled backend
            # has no grad mode and differentiates the geometry too
            assert leaf.grad is None or float(leaf.grad.abs().max()) == 0.0, nm
            continue
        assert leaf.grad is not None, nm
        np.testing.assert_allclose(leaf.grad.numpy(), jg, atol=GRAD_ATOL, err_msg=nm)
    if grad_mode == "full":
        assert float(np.abs(jgrads[5]).max()) > 1e-4   # the tap carries a gradient


def test_tiled_backward_is_bit_equal_over_two_runs():
    grads = []
    for _ in range(2):
        loss, leaves, _ = port_tiled_loss("full_overflow")
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b, nm in zip(*grads, NAMES):
        assert torch.equal(a, b), nm


@pytest.mark.parametrize("include_feature", [False, True])
def test_render_with_the_tiled_backend_matches_jax(include_feature):
    from langsplat_tpu.ops.render import RenderSettings as JaxSettings
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    from langsplat_tpu_torch.ops.render import RenderSettings, render

    from tests.test_torch_render import cam_tensors, field_params, jax_field, jax_render

    params = field_params()
    cam = make_camera(w=64, h=48)
    common = dict(image_height=48, image_width=64, tanfovx=cam["tanfovx"],
                  tanfovy=cam["tanfovy"], sh_degree=3, include_feature=include_feature,
                  budget=4096, max_tiles_per_gaussian=64, backend="tiled",
                  max_per_tile=24)
    bg = [0.2, 0.4, 0.6]
    want = jax_render(jax_field(params), JaxSettings(**common, interpret=True),
                      cam["viewmatrix"], cam["projmatrix"], cam["campos"],
                      jnp.asarray(bg))
    got = render(from_numpy(params, "cpu"), RenderSettings(**common), *cam_tensors(cam),
                 torch.tensor(bg))
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL,
                                   err_msg=k)
    with pytest.raises(ValueError, match="backend"):
        render(from_numpy(params, "cpu"), RenderSettings(**dict(common, backend="pallas")),
               *cam_tensors(cam), torch.tensor(bg))
