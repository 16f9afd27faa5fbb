"""PyTorch port, blend backward: the port's gradients (plain backward on the CPU, through
the preprocess and the screen-space means2D tap) against `jax.grad` of the JAX
package's `rasterize_pallas` in interpret mode, on the scenes of
tests/test_pallas_blend.py, with F = 0 and 3, both grad modes and a non-zero
background; and the explicit plain backward against `torch.autograd` through the plain
forward. (The CUDA kernel is held against the plain backward in
tests/test_torch_cuda.py.)

Tolerance: 5e-5 absolute, the JAX package's own Pallas-vs-dense gradient tolerance
(tests/test_pallas_blend.py:89); the Pallas kernel takes T as exp(cumsum(log(1 - a))).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.ops import projection as jproj
from langsplat_tpu.ops.rasterize_pallas import rasterize_pallas
from langsplat_tpu.ops.tiles import bin_gaussians as jax_bin_gaussians
from langsplat_tpu_torch.ops import _build, projection, rasterize_cuda, tiles

from tests.test_projection_and_dense import make_camera
from tests.test_tiles import random_scene

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 5e-5

# name -> (n, seed, spread, w, h, budget, tmax, num_feat, grad_mode, bg)
SCENES = {
    "gradients": (40, 7, 1.0, 32, 32, 2048, 16, 3, "full", [0.2, 0.5, 0.8]),
    "rgb_only": (40, 7, 1.0, 32, 32, 2048, 16, 0, "full", [0.2, 0.5, 0.8]),
    "feature_mode": (40, 17, 1.0, 32, 32, 2048, 16, 3, "feature", [0.0, 0.0, 0.0]),
    "dense_64x48": (120, 3, 2.0, 64, 48, 8192, 64, 3, "full", [0.1, 0.3, 1.0]),
    "odd_tiles": (60, 13, 2.0, 48, 16, 2048, 16, 3, "full", [0.5, 0.1, 0.2]),
    "feature_odd": (60, 13, 2.0, 48, 16, 2048, 16, 3, "feature", [0.5, 0.1, 0.2]),
}
NAMES = ("means", "scales", "opac", "colors", "feats", "tap")


def targets(w, h):
    rng = np.random.default_rng(0)
    return (rng.uniform(size=(3, h, w)).astype(np.float32),
            rng.uniform(size=(3, h, w)).astype(np.float32))


def loss_of(out, target, ftarget, num_feat, grad_mode, xp):
    """The loss of tests/test_pallas_blend.py:57-60 (the feature image alone in grad
    mode "feature", whose backward yields only feature gradients)."""
    loss = xp.mean((out["language_feature_image"] - ftarget) ** 2) if num_feat else 0.0
    if grad_mode == "full":
        loss = (loss + xp.mean((out["render"] - target) ** 2)
                + 0.1 * xp.mean(out["final_transmittance"]))
    return loss


def jax_grads(name):
    n, seed, spread, w, h, budget, tmax, num_feat, grad_mode, bg = SCENES[name]
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
        out = rasterize_pallas(prep, inst, opac_, feats_ if num_feat else None,
                               jnp.asarray(bg), image_height=h, image_width=w,
                               tile_size=16, chunk=32, interpret=True,
                               means2d_override=prep.means2d + tap, grad_mode=grad_mode)
        return loss_of(out, target, ftarget, num_feat, grad_mode, jnp)

    args = [jnp.asarray(x) for x in (means, scales, opac, colors, feats)]
    args.append(jnp.zeros((n, 2), jnp.float32))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn, argnums=tuple(range(6))))(*args)
    return float(loss), [np.asarray(g) for g in grads]


def port_render(name, device="cpu"):
    """(loss, leaves) of the port's render of scene `name`; the leaves require grad."""
    n, seed, spread, w, h, budget, tmax, num_feat, grad_mode, bg = SCENES[name]
    cam = make_camera(w=w, h=h)
    means, scales, quats, colors, opac, feats = random_scene(n, seed=seed, spread=spread)
    target, ftarget = targets(w, h)
    leaves = [torch.tensor(x, device=device, requires_grad=True)
              for x in (means, scales, opac, colors, feats)]
    leaves.append(torch.zeros((n, 2), device=device, requires_grad=True))
    means_t, scales_t, opac_t, colors_t, feats_t, tap = leaves
    mats = [torch.tensor(np.asarray(cam[k]), device=device)
            for k in ("viewmatrix", "projmatrix", "campos")]
    prep = projection.preprocess(
        means_t, scales_t, torch.tensor(quats, device=device), None, *mats,
        image_height=h, image_width=w, tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
        sh_degree=0, tile_size=16, colors_precomp=colors_t)
    inst = tiles.bin_gaussians(projection.PreprocessOut(*(t.detach() for t in prep)),
                               grid_x=-(-w // 16), grid_y=-(-h // 16), budget=budget,
                               max_tiles_per_gaussian=tmax)
    out = rasterize_cuda.rasterize(
        prep, inst, opac_t, feats_t if num_feat else None,
        torch.tensor(bg, device=device), image_height=h, image_width=w, tile_size=16,
        means2d_override=prep.means2d + tap, grad_mode=grad_mode)
    loss = loss_of(out, torch.tensor(target, device=device),
                   torch.tensor(ftarget, device=device), num_feat, grad_mode, torch)
    return loss, leaves


@pytest.mark.parametrize("name", sorted(SCENES))
def test_port_gradients_match_jax(name):
    num_feat, grad_mode = SCENES[name][7], SCENES[name][8]
    jloss, jgrads = jax_grads(name)
    launches = dict(_build.LAUNCHES)
    loss, leaves = port_render(name)
    loss.backward()
    assert _build.LAUNCHES == launches      # CPU tensors: the plain versions
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    for nm, leaf, jg in zip(NAMES, leaves, jgrads):
        if grad_mode == "feature" and nm != "feats" or nm == "feats" and not num_feat:
            assert leaf.grad is None or float(leaf.grad.abs().max()) == 0.0, nm
            continue
        assert leaf.grad is not None, nm
        np.testing.assert_allclose(leaf.grad.numpy(), jg, atol=ATOL, err_msg=nm)
    if grad_mode == "full":
        assert float(np.abs(jgrads[5]).max()) > 1e-4   # the tap carries a gradient


@pytest.mark.parametrize("num_feat", [0, 3])
def test_plain_backward_matches_autograd_of_plain_forward(num_feat):
    """The explicit front-to-back backward against torch.autograd through the plain
    forward, on the per-Gaussian inputs of the blend."""
    n, seed, spread, w, h, budget, tmax, _, _, bg = SCENES["dense_64x48"]
    cam = make_camera(w=w, h=h)
    means, scales, quats, colors, opac, feats = random_scene(n, seed=seed, spread=spread)
    mats = [torch.tensor(np.asarray(cam[k])) for k in ("viewmatrix", "projmatrix",
                                                       "campos")]
    prep = projection.preprocess(
        torch.tensor(means), torch.tensor(scales), torch.tensor(quats), None, *mats,
        image_height=h, image_width=w, tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
        sh_degree=0, tile_size=16, colors_precomp=torch.tensor(colors))
    inst = tiles.bin_gaussians(prep, grid_x=4, grid_y=3, budget=budget,
                               max_tiles_per_gaussian=tmax)
    rng = np.random.default_rng(5)
    g_image = torch.tensor(rng.normal(size=(3 + num_feat, h, w)).astype(np.float32))
    g_t = torch.tensor(rng.normal(size=(h, w)).astype(np.float32))
    bg_t = torch.tensor(bg)
    size = dict(image_height=h, image_width=w, tile_size=16)

    leaves = [x.clone().requires_grad_(True) for x in (
        prep.means2d, prep.conics, torch.tensor(opac), prep.colors, torch.tensor(feats))]
    m2, co, op, col, ft = leaves
    feats_in = ft if num_feat else None
    image, t_final = rasterize_cuda.blend_forward_plain(
        m2, co, op, prep.visible, col, feats_in, inst.gauss_id, inst.tile_start, bg_t,
        **size)
    ((image * g_image).sum() + (t_final * g_t).sum()).backward()

    g_tfinal, total = rasterize_cuda.backward_residuals(image.detach(), t_final.detach(),
                                                        bg_t, g_image, g_t)
    d_pre, t_replay = rasterize_cuda.blend_backward_plain(
        prep.means2d, prep.conics, torch.tensor(opac), prep.visible, prep.colors,
        torch.tensor(feats) if num_feat else None, inst.gauss_id, inst.tile_start,
        inst.presort_slot, g_image, g_tfinal, total, t_final.detach(), grad_mode="full",
        return_t=True, **size)
    assert torch.equal(t_replay, t_final.detach())
    ends = torch.clamp(inst.gauss_offsets, 0, budget)
    from langsplat_tpu_torch.ops.segsum import segment_sum
    per_gauss = segment_sum(d_pre, ends, n).T
    vis = prep.visible
    want = {"means2d": m2.grad, "conics": co.grad, "opacity": op.grad * vis,
            "colors": col.grad}
    got = {"means2d": per_gauss[:, 0:2], "conics": per_gauss[:, 2:5],
           "opacity": per_gauss[:, 5] * vis, "colors": per_gauss[:, 6:9]}
    if num_feat:
        want["features"], got["features"] = ft.grad, per_gauss[:, 9:]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_backward_rows_and_refusals():
    assert rasterize_cuda.grad_rows(3, "full") == 12
    assert rasterize_cuda.grad_rows(3, "feature") == 3
    with pytest.raises(ValueError, match="requires language feature"):
        rasterize_cuda.grad_rows(0, "feature")
    with pytest.raises(ValueError, match="grad_mode"):
        rasterize_cuda.grad_rows(3, "geometry")
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_cuda.blend_backward_cuda(
            z((4, 2)), z((4, 3)), z(4), z(4, dtype=torch.bool), z((4, 3)), None,
            z(8, dtype=torch.int32), z(2, dtype=torch.int32), z(8, dtype=torch.int32),
            z((3, 16, 16)), z((16, 16)), z((16, 16)), z((16, 16)), grad_mode="full",
            image_height=16, image_width=16, tile_size=16)
