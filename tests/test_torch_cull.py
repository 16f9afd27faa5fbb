"""PyTorch port, the warp-region cull of both blend kernels, forward and backward
(csrc/blend_common.cuh stage_batch), through its plain mirror
`rasterize_cuda.warp_region_keep` / `cull_box_keep` (the same float32 arithmetic and
margins):

- every (instance, pixel) pair the plain forward blends lies in a warp region the cull
  keeps, so the kernels skip no pair that blends (and K2's replayed T stays K1's);
- the plain forward restricted to the kept (instance, region) pairs, as the forward
  kernel walks them, gives the same image and final T, bit for bit, as the plain
  forward over every pair;
- taken at 16x16 granularity, the cull keeps every tile that the JAX package's exact
  tile cull `tile_pass_mask` (langsplat_tpu/ops/tiles.py:118) keeps, for visible
  Gaussians whose tile rect fits in tmax (past tmax JAX keeps every tile uncut).

Scenes are built in screen space with numpy from a seed (means, sigmas in pixels and
rotations give the conics), binned uncut as the training path bins large rects, and
include an opacity-reset field (opacities 0.005-0.02, sigma 10-30 px), thin ellipses,
an image whose size is not a multiple of the tile, and degenerate or NaN conics and
means, zero and above-one opacities.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.ops import projection as jproj
from langsplat_tpu.ops.tiles import tile_pass_mask as jax_tile_pass_mask
from langsplat_tpu_torch.ops import projection, rasterize_cuda, tiles
from langsplat_tpu_torch.ops.rasterize_reference import ALPHA_EPS, TERM_EPS

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

TILE = 16

# name -> (n, w, h, seed, opacity range, sigma range in px (major, minor), corrupt)
SCENES = {
    "reset_low_opacity": (60, 96, 80, 0, (0.005, 0.02), ((10, 30), (10, 30)), False),
    "opaque_small": (150, 96, 80, 1, (0.2, 0.95), ((1, 6), (1, 6)), False),
    "thin_ellipses": (80, 96, 80, 2, (0.05, 0.9), ((5, 30), (0.3, 2)), False),
    "odd_image": (90, 77, 53, 3, (0.005, 0.9), ((1, 20), (1, 20)), False),
    "degenerate_nan": (90, 96, 80, 4, (0.005, 0.9), ((2, 25), (2, 25)), True),
}


def make_scene(n, w, h, seed, opac_range, sigma_range, corrupt):
    """Screen-space inputs of the blend as preprocess lays them out (numpy float32)."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-10, w + 10, n), rng.uniform(-10, h + 10, n)], 1)
    major = rng.uniform(*sigma_range[0], n)
    minor = np.minimum(rng.uniform(*sigma_range[1], n), major)
    theta = rng.uniform(0, np.pi, n)
    cos, sin = np.cos(theta), np.sin(theta)
    cxx = major ** 2 * cos ** 2 + minor ** 2 * sin ** 2
    cyy = major ** 2 * sin ** 2 + minor ** 2 * cos ** 2
    cxy = (major ** 2 - minor ** 2) * cos * sin
    det = cxx * cyy - cxy ** 2
    conics = np.stack([cyy / det, -cxy / det, cxx / det], 1)
    opac = rng.uniform(*opac_range, n)
    radius = np.ceil(3 * major)
    if corrupt:
        k = np.arange(n) % 9
        conics[k == 1, 0] = -0.01                                # a <= 0
        conics[k == 2, 2] = 0.0                                  # c = 0
        ac = conics[:, 0] * conics[:, 2]
        conics[k == 3, 1] = np.sqrt(ac[k == 3]) * 1.0001          # ac - b^2 < 0
        conics[k == 4, 1] = np.sqrt(ac[k == 4]) * 0.99999         # nearly degenerate
        conics[k == 5, 1] = np.nan
        opac[k == 6] = 0.0
        opac[k == 7] = 1.5                                       # an unactivated opacity
    grid_x, grid_y = -(-w // TILE), -(-h // TILE)
    tmin = np.stack([np.clip((means[:, 0] - radius) // TILE, 0, grid_x),
                     np.clip((means[:, 1] - radius) // TILE, 0, grid_y)], 1)
    tmax = np.stack([np.clip((means[:, 0] + radius + TILE - 1) // TILE, 0, grid_x),
                     np.clip((means[:, 1] + radius + TILE - 1) // TILE, 0, grid_y)], 1)
    visible = (tmax - tmin).prod(axis=1) > 0
    visible[rng.uniform(size=n) < 0.05] = False
    if corrupt:
        means[np.arange(n) % 9 == 8, 0] = np.nan                 # NaN mean, rect kept
    f32 = np.float32
    return dict(means2d=means.astype(f32), depths=rng.uniform(1, 10, n).astype(f32),
                conics=conics.astype(f32), radii=np.where(visible, radius, 0).astype(np.int32),
                colors=rng.uniform(size=(n, 3)).astype(f32),
                tiles_min=tmin.astype(np.int32), tiles_max=tmax.astype(np.int32),
                visible=visible, opac=opac.astype(f32))


def port_prep(s):
    return projection.PreprocessOut(*(torch.tensor(s[k]) for k in projection.PreprocessOut._fields))


def binned_uncut(name):
    """(prep, opacities, instance buffer, grid_x) of scene `name`, binned uncut, as the
    training path bins rects past the culled tile cap."""
    n, w, h = SCENES[name][:3]
    s = make_scene(*SCENES[name])
    prep = port_prep(s)
    grid_x, grid_y = -(-w // TILE), -(-h // TILE)
    inst = tiles.bin_gaussians(prep, grid_x=grid_x, grid_y=grid_y, budget=n * grid_x * grid_y,
                               max_tiles_per_gaussian=grid_x * grid_y, tile_size=TILE,
                               cull=False)
    assert int(inst.dropped) == 0 and int(inst.rect_dropped) == 0
    return prep, torch.tensor(s["opac"]), inst, grid_x


@pytest.mark.parametrize("name", sorted(SCENES))
def test_cull_keeps_every_blended_pair(name):
    w, h = SCENES[name][1:3]
    prep, opac, inst, grid_x = binned_uncut(name)
    args = rasterize_cuda.blend_args(prep, inst, opac, None, torch.zeros(3))
    evaluated, blended, blended_in = rasterize_cuda.blend_pairs(
        *args, image_height=h, image_width=w, tile_size=TILE)
    keep = rasterize_cuda.warp_region_keep(prep.means2d, prep.conics, opac, prep.visible,
                                           inst.gauss_id, inst.tile_id, grid_x=grid_x)
    num = int(inst.num_instances)
    assert keep.shape == blended_in.shape == (inst.gauss_id.shape[0], 8)
    assert not bool(keep[num:].any())
    missed = blended_in & ~keep
    assert int(missed.sum()) == 0, f"{int(missed.sum())} blended regions culled"
    assert blended > 0 and int(blended_in.sum()) > 0
    share = float(keep[:num].float().mean())
    assert 0.0 < share < 1.0          # the cull both keeps and skips on every scene
    if name == "reset_low_opacity":
        assert share < 0.5            # most (instance, region) pairs are skipped
    if name == "degenerate_nan":
        # where the test cannot be trusted, every region of every tile is kept
        gid = inst.gauss_id[:num].to(torch.int64)
        co, op = prep.conics[gid], opac[gid]
        untrusted = ((co[:, 0] <= 0) | (co[:, 2] <= 0) | torch.isnan(co).any(dim=1)
                     | (co[:, 0] * co[:, 2] - co[:, 1] ** 2 <= 0) | (op <= 0)
                     | torch.isnan(prep.means2d[gid]).any(dim=1))
        assert int(untrusted.sum()) > 0
        assert bool(keep[:num][untrusted].all())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_cull_keeps_every_tile_jax_keeps(name):
    n, w, h = SCENES[name][:3]
    s = make_scene(*SCENES[name])
    grid_x, grid_y = -(-w // TILE), -(-h // TILE)
    tmax = 64
    jprep = jproj.PreprocessOut(*(jnp.asarray(s[k]) for k in jproj.PreprocessOut._fields))
    words = np.asarray(jax_tile_pass_mask(jprep, tile_size=TILE, tmax=tmax,
                                          opacities=jnp.asarray(s["opac"])))
    j = np.arange(tmax)
    jax_keep = ((words[:, j // 32] >> (j % 32).astype(np.uint32)) & 1).astype(bool)
    rw = s["tiles_max"][:, 0] - s["tiles_min"][:, 0]
    rh = s["tiles_max"][:, 1] - s["tiles_min"][:, 1]
    fits = s["visible"] & (rw * rh <= tmax)
    g, pos = np.nonzero(fits[:, None] & (j[None, :] < (rw * rh)[:, None]))
    tx = s["tiles_min"][g, 0] + pos % rw[g]
    ty = s["tiles_min"][g, 1] + pos // rw[g]
    prep = port_prep(s)
    ours = rasterize_cuda.cull_box_keep(
        prep.means2d, prep.conics, torch.tensor(s["opac"]), prep.visible,
        torch.tensor(g), torch.tensor(tx * TILE), torch.tensor(ty * TILE), TILE, TILE)
    want = jax_keep[g, pos]
    assert want.sum() > 0 and (~want).sum() > 0
    missed = want & ~ours.numpy()
    assert int(missed.sum()) == 0, f"{int(missed.sum())} tiles JAX keeps are culled"


def plain_forward_over_kept(args, keep, *, image_height, image_width, tile_size=TILE):
    """The plain forward (`rasterize_cuda._blend_plain`'s arithmetic, operation for
    operation) over only the (instance, warp region) pairs `keep` [budget, regions]
    marks, as the forward kernel walks them: a pixel outside its instance's kept regions
    does not evaluate that instance. Returns (image, final T)."""
    means2d, conics, opacities, visible, colors, features, gauss_id, tile_start, bg = args
    rc = rasterize_cuda
    attrs = colors if features is None else torch.cat([colors, features], dim=1)
    opa = torch.where(visible, opacities, 0.0)
    starts = tile_start[:-1].to(torch.int64)
    counts = (tile_start[1:] - tile_start[:-1]).to(torch.int64)
    px, py, inside = rc._pixel_grid(image_height, image_width, tile_size, means2d.device)
    fx, fy = px.to(torch.float32), py.to(torch.float32)
    lp = torch.arange(tile_size * tile_size)
    region_of = ((lp // tile_size) // rc.REGION_H * (tile_size // rc.REGION_W)
                 + (lp % tile_size) // rc.REGION_W)        # [P], warp numbering
    T = torch.ones(px.shape, dtype=torch.float32)
    acc = torch.zeros((px.shape[0], attrs.shape[1]) + px.shape[1:], dtype=torch.float32)
    done = ~inside
    last = max(gauss_id.shape[0] - 1, 0)
    for k in range(int(counts.max()) if px.shape[0] else 0):
        if k % 32 == 0 and bool(done.all()):
            break
        idx = torch.clamp(starts + k, max=last)
        live = (k < counts)[:, None] & ~done & keep[idx][:, region_of]
        gid = torch.where(k < counts, gauss_id[idx].to(torch.int64), 0)
        _, _, power, _, _, alpha = rc._instance_alpha(means2d, conics, opa, gid, fx, fy)
        ok = live & (power <= 0.0) & (alpha >= ALPHA_EPS)
        test_t = T * (1.0 - alpha)
        term = ok & (test_t < TERM_EPS)
        blend = ok & ~term
        w = torch.where(blend, alpha * T, 0.0)
        acc = acc + w[:, None, :] * attrs[gid][:, :, None]
        T = torch.where(blend, test_t, T)
        done = done | term
    acc = torch.cat([acc[:, :3] + T[:, None, :] * bg[None, :, None], acc[:, 3:]], dim=1)
    size = dict(image_height=image_height, image_width=image_width, tile_size=tile_size)
    return rc._to_image(acc, **size), rc._to_image(T[:, None], **size)[0]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_forward_over_kept_regions_is_unchanged(name):
    """The forward kernel's walk, in plain PyTorch: restricted to the cull's kept
    (instance, region) pairs, the blend gives the same image and T bit for bit."""
    n, w, h = SCENES[name][:3]
    prep, opac, inst, grid_x = binned_uncut(name)
    rng = np.random.default_rng(SCENES[name][3])
    feats = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32))
    args = rasterize_cuda.blend_args(prep, inst, opac, feats,
                                     torch.tensor([0.2, 0.5, 0.9]))
    keep = rasterize_cuda.warp_region_keep(prep.means2d, prep.conics, opac, prep.visible,
                                           inst.gauss_id, inst.tile_id, grid_x=grid_x)
    size = dict(image_height=h, image_width=w, tile_size=TILE)
    image, t_final = rasterize_cuda.blend_forward_plain(*args, **size)
    culled_image, culled_t = plain_forward_over_kept(args, keep, image_height=h,
                                                     image_width=w)
    assert not bool(keep[:int(inst.num_instances)].all())    # the cull skips pairs
    assert float((1.0 - t_final).max()) > 0.1                # and something blends
    assert torch.equal(culled_t, t_final)
    assert torch.equal(culled_image, image)
