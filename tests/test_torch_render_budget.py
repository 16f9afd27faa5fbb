"""PyTorch port, the overflow paths: `render_full`'s retries at a grown instance budget and
tile cap, its ceiling (the error, and the truncated render it returns when truncation is
allowed), and the tile blend's forward and backward on a truncated instance buffer, each
against the JAX package on the CPU.

The retry cases use the field of tests/test_render_budget.py (80 large splats at
128x128, capacity 128, budget_factor=1, max_tiles_per_gaussian=16), whose first pass
drops both instances and tile positions. The JAX side runs `interpret=True` as its own
test does (the tiled backend); the port runs with device="cpu", through the blend's
plain version (the "cuda" backend) and through its tiled backend. The attempts are
recorded by wrapping `make_settings` in each package's `train/loop.py`.

Tolerances: 3e-5 on images (the JAX package's Pallas-vs-dense tolerance) and 5e-5 on
gradients (its Pallas-vs-dense gradient tolerance, tests/test_pallas_blend.py:89).
"""

import re
from dataclasses import replace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu import config as jconfig
from langsplat_tpu.models import gaussian_field as jgf
from langsplat_tpu.ops.rasterize_pallas import rasterize_pallas
from langsplat_tpu.train import loop as jloop
from langsplat_tpu_torch import config as tconfig
from langsplat_tpu_torch.models.gaussian_field import FIELD_NAMES, from_numpy
from langsplat_tpu_torch.ops import _build, rasterize_cuda
from langsplat_tpu_torch.train import loop as tloop

from tests.test_parallel import batched_cameras
from tests.test_projection_and_dense import make_camera
from tests.test_tiles import random_scene
from tests.test_torch_rasterize import to_torch
from tests.test_torch_tiles import jax_bin, jax_prep

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

IMG_ATOL = 3e-5
GRAD_ATOL = 5e-5
H = W = 128
PIPE = dict(budget_factor=1, max_tiles_per_gaussian=16)


class _Cam:
    def __init__(self, view, proj, cpos, tanf, h, w):
        self.world_view_transform = np.array(view)
        self.full_proj_transform = np.array(proj)
        self.camera_center = np.array(cpos)
        self.tanfovx = self.tanfovy = tanf
        self.height, self.width = h, w


def budget_camera(facing_away=False):
    views, projs, cpos, tanf = batched_cameras(v=1, w=W, h=H)
    view, proj = np.asarray(views[0]), np.asarray(projs[0])
    if facing_away:
        # turned half a circle about the view's y axis: every splat is behind it
        flip = np.diag([-1.0, 1.0, -1.0, 1.0]).astype(np.float32)
        view, proj = view @ flip, view @ flip @ np.linalg.solve(view, proj)
    return _Cam(view, proj, cpos[0], tanf, H, W)


def budget_field():
    """The JAX test's field: 80 huge splats, each touching most of the 64-tile grid."""
    n, cap = 80, 128
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)),
                          rng.uniform(4, 6, (n, 1))], axis=1).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    field = jgf.create_from_pcd(pts, cols, sh_degree=0, capacity=cap)
    return replace(field, scaling=jnp.full((cap, 3), np.log(3.0)),
                   opacity=jnp.full((cap, 1), 2.0))


def port_field(jfield):
    return from_numpy({k: np.array(getattr(jfield, k)) for k in FIELD_NAMES
                       if getattr(jfield, k) is not None}, "cpu")


def recorded(monkeypatch, module, attempts):
    """Wrap module.make_settings so that each render_full attempt appends its
    (budget, max_tiles_per_gaussian)."""
    inner = module.make_settings

    def make_settings(*args, **kw):
        settings = inner(*args, **kw)
        attempts.append((settings.budget, settings.max_tiles_per_gaussian))
        return settings

    monkeypatch.setattr(module, "make_settings", make_settings)


def both_render_full(monkeypatch, port_interpret, cam=None, start=None, **pipe_kw):
    """render_full of the budget field in the JAX package and in the port, from the
    budget and tile cap of `start` (default: the policy's): (JAX output, port output,
    JAX attempts, port attempts); an output is the RuntimeError raised."""
    cam = cam or budget_camera()
    jfield = budget_field()
    runs = {}
    for name, module, pipe, field, kw in (
            ("jax", jloop, jconfig.PipelineConfig(interpret=True, **PIPE, **pipe_kw),
             jfield, dict(bg=jnp.zeros(3))),
            ("port", tloop, tconfig.PipelineConfig(interpret=port_interpret, **PIPE,
                                                   **pipe_kw),
             port_field(jfield), dict(bg=[0.0, 0.0, 0.0], device="cpu"))):
        attempts = []
        recorded(monkeypatch, module, attempts)
        try:
            out = module.render_full(field, cam, pipe, 0, False, **kw, **(start or {}))
        except RuntimeError as err:
            out = err
        runs[name] = (out, attempts)
    return runs["jax"][0], runs["port"][0], runs["jax"][1], runs["port"][1]


def assert_images_agree(jout, tout):
    for k in ("render", "final_transmittance"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=IMG_ATOL,
                                   err_msg=k)
    for k in ("instances_dropped", "rect_dropped"):
        assert int(tout[k]) == int(jout[k]), k


BACKENDS = {"plain": False, "tiled": True}
# the policy's budget and tile cap, or a budget and cap far below what the view needs
STARTS = {"policy": None, "small": dict(budget=512, max_tiles=2)}


@pytest.mark.parametrize("start", sorted(STARTS))
@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_render_full_retries_like_jax(monkeypatch, backend, start):
    """The same attempts, (budget, max_tiles) in order, both caps grown; nothing dropped
    at the end; the image within 3e-5."""
    jout, tout, jatt, tatt = both_render_full(monkeypatch, BACKENDS[backend],
                                              start=STARTS[start])
    assert tatt == jatt
    assert len(tatt) > (4 if start == "small" else 2)
    assert tatt[-1][0] > tatt[0][0] and tatt[-1][1] > tatt[0][1]
    assert int(tout["instances_dropped"]) == int(tout["rect_dropped"]) == 0
    assert_images_agree(jout, tout)
    assert float(np.asarray(jout["final_transmittance"]).min()) < 0.5   # splats drawn


def test_render_full_ceiling_raises_like_jax(monkeypatch):
    """At a ceiling below what the view needs, both raise with the same message: the
    same dropped instances, cap, rect positions, tile cap and capacity."""
    for module in (jloop, tloop):
        monkeypatch.setattr(module, "RENDER_BUDGET_CEILING", 2048)
    jerr, terr, jatt, tatt = both_render_full(monkeypatch, False)
    assert isinstance(jerr, RuntimeError) and isinstance(terr, RuntimeError)
    assert str(terr) == str(jerr)
    dropped = int(re.search(r"render dropped (\d+) instances", str(terr)).group(1))
    assert dropped > 0 and "budget cap 2048" in str(terr)
    assert tatt == jatt


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_render_full_truncated_at_the_ceiling_like_jax(monkeypatch, backend):
    """With allow_budget_truncation, render_full returns the truncated render at the
    ceiling; the image within 3e-5 of JAX's, the same drop counts."""
    for module in (jloop, tloop):
        monkeypatch.setattr(module, "RENDER_BUDGET_CEILING", 2048)
    jout, tout, jatt, tatt = both_render_full(monkeypatch, BACKENDS[backend],
                                              allow_budget_truncation=True)
    assert tatt == jatt and tatt[-1][0] == 2048
    assert int(tout["instances_dropped"]) > 0
    assert_images_agree(jout, tout)


def test_render_full_of_an_empty_view_like_jax(monkeypatch):
    """A camera facing away from the field: one attempt, nothing binned, the
    background everywhere and T = 1, in both."""
    cam = budget_camera(facing_away=True)
    jout, tout, jatt, tatt = both_render_full(monkeypatch, False, cam=cam)
    assert tatt == jatt and len(tatt) == 1
    assert not bool(tout["visibility_filter"].any())
    assert_images_agree(jout, tout)
    assert bool((tout["final_transmittance"] == 1.0).all())
    assert bool((tout["render"] == 0.0).all())


# ---------------------------------------------------------------------------
# The blend on a truncated instance buffer
# ---------------------------------------------------------------------------

# (num_feat, grad_mode): both feature counts, both grad modes
TRUNCATED = [(0, "full"), (3, "full"), (3, "feature")]
TRUNC_SCENE = dict(n=60, seed=13, w=64, h=48)
TRUNC_BUDGET = 96
TRUNC_BG = [0.2, 0.5, 0.8]


def truncated_inputs():
    """A scene whose binning lists more instances than TRUNC_BUDGET: its preprocess
    output and truncated InstanceBuffer (the JAX package's; the port's equals it field
    for field, tests/test_torch_tiles.py)."""
    n, seed, w, h = (TRUNC_SCENE[k] for k in ("n", "seed", "w", "h"))
    cam = make_camera(w=w, h=h)
    means, scales, quats, colors, opac, feats = random_scene(n, seed=seed)
    prep = jax_prep(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats), None,
                    cam["viewmatrix"], cam["projmatrix"], cam["campos"], image_height=h,
                    image_width=w, tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
                    sh_degree=0, tile_size=16, colors_precomp=jnp.asarray(colors))
    inst = jax_bin(prep, grid_x=-(-w // 16), grid_y=-(-h // 16), budget=TRUNC_BUDGET,
                   max_tiles_per_gaussian=16, tile_size=16, opacities=jnp.asarray(opac))
    return prep, inst, opac, feats


def blend_loss(out, num_feat, grad_mode, xp):
    """The loss of tests/test_torch_blend_bwd.py against fixed targets."""
    h, w = TRUNC_SCENE["h"], TRUNC_SCENE["w"]
    rng = np.random.default_rng(0)
    target = xp.asarray(rng.uniform(size=(3, h, w)).astype(np.float32))
    ftarget = xp.asarray(rng.uniform(size=(3, h, w)).astype(np.float32))
    loss = xp.mean((out["language_feature_image"] - ftarget) ** 2) if num_feat else 0.0
    if grad_mode == "full":
        loss = (loss + xp.mean((out["render"] - target) ** 2)
                + 0.1 * xp.mean(out["final_transmittance"]))
    return loss


@pytest.mark.parametrize("num_feat,grad_mode", TRUNCATED)
def test_truncated_blend_forward_and_backward_match_jax(num_feat, grad_mode):
    """The port's `rasterize` (plain versions on the CPU) against JAX's
    `rasterize_pallas` in interpret mode on the same truncated buffer: image within
    3e-5, gradients of means2d, conics, opacities, colors and features within 5e-5;
    a Gaussian whose instances were all dropped gets zero gradients in both."""
    prep, inst, opac, feats = truncated_inputs()
    h, w = TRUNC_SCENE["h"], TRUNC_SCENE["w"]
    size = dict(image_height=h, image_width=w, tile_size=16)
    offsets = np.asarray(inst.gauss_offsets)
    listed = offsets[1:] > offsets[:-1]
    all_dropped = listed & (offsets[:-1] >= TRUNC_BUDGET)
    partly = listed & (offsets[:-1] < TRUNC_BUDGET) & (offsets[1:] > TRUNC_BUDGET)
    assert int(inst.dropped) > 0 and all_dropped.sum() >= 3
    assert int(inst.num_instances) == TRUNC_BUDGET
    assert partly.sum() + all_dropped.sum() < listed.sum()   # some kept whole too
    leaves = (np.asarray(prep.means2d), np.asarray(prep.conics), opac,
              np.asarray(prep.colors), feats)

    def jax_loss(means2d, conics, opac_, colors, feats_):
        p = prep._replace(conics=conics, colors=colors)
        out = rasterize_pallas(p, inst, opac_, feats_ if num_feat else None,
                               jnp.asarray(TRUNC_BG), **size, chunk=32, interpret=True,
                               means2d_override=means2d, grad_mode=grad_mode)
        return blend_loss(out, num_feat, grad_mode, jnp), out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True))(*map(jnp.asarray, leaves))

    tprep, tinst = to_torch(prep, inst)
    xs = [torch.tensor(x, requires_grad=True) for x in leaves]
    launches = dict(_build.LAUNCHES)
    tout = rasterize_cuda.rasterize(
        tprep._replace(conics=xs[1], colors=xs[3]), tinst, xs[2],
        xs[4] if num_feat else None, torch.tensor(TRUNC_BG), **size,
        means2d_override=xs[0], grad_mode=grad_mode)
    loss = blend_loss(tout, num_feat, grad_mode, torch)
    loss.backward()
    assert _build.LAUNCHES == launches        # CPU tensors: the plain versions
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    keys = ["render", "final_transmittance"] + (["language_feature_image"]
                                                if num_feat else [])
    for k in keys:
        np.testing.assert_allclose(tout[k].detach().numpy(), np.asarray(jout[k]),
                                   atol=IMG_ATOL, err_msg=k)
    names = ("means2d", "conics", "opacities", "colors", "features")
    for name, x, jg in zip(names, xs, jgrads):
        jg = np.asarray(jg)
        if grad_mode == "feature" and name != "features" or (
                name == "features" and not num_feat):
            assert x.grad is None or float(x.grad.abs().max()) == 0.0, name
            assert float(np.abs(jg).max()) == 0.0, name
            continue
        got = x.grad.numpy()
        np.testing.assert_allclose(got, jg, atol=GRAD_ATOL, err_msg=name)
        assert float(np.abs(jg[partly]).max()) > 0, name
        assert float(np.abs(got[all_dropped]).max()) == 0.0, name
        assert float(np.abs(jg[all_dropped]).max()) == 0.0, name
