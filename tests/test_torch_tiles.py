"""PyTorch port, binning: `langsplat_tpu_torch.ops.tiles.bin_gaussians` must equal the JAX
`bin_gaussians` exactly, on every InstanceBuffer field, when both bin the same
preprocess output (the sort keys are unique, so there is one right answer)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.ops import projection as jproj
from langsplat_tpu.ops import tiles as jtiles
from langsplat_tpu_torch.ops import tiles as ttiles
from langsplat_tpu_torch.ops.projection import PreprocessOut

from tests.test_projection_and_dense import make_camera
from tests.test_tiles import random_scene

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

FIELDS = ("gauss_id", "tile_id", "tile_start", "num_instances", "dropped",
          "rect_dropped", "presort_slot", "gauss_offsets")


def to_torch_prep(prep) -> PreprocessOut:
    return PreprocessOut(*(torch.tensor(np.asarray(x)) for x in prep))


BIN_STATIC = ("grid_x", "grid_y", "budget", "max_tiles_per_gaussian", "tile_size")
# one compiled program per case instead of one per eager op
jax_prep = jax.jit(jproj.preprocess, static_argnames=(
    "image_height", "image_width", "tanfovx", "tanfovy", "sh_degree", "tile_size"))
jax_bin = jax.jit(jtiles.bin_gaussians, static_argnames=BIN_STATIC)
jax_counts = jax.jit(jtiles.instance_counts, static_argnames=("tile_size", "tmax"))
jax_mask = jax.jit(jtiles.tile_pass_mask, static_argnames=("tile_size", "tmax"))


def bin_both(prep, opac, **kw):
    j = jax_bin(prep, opacities=None if opac is None else jnp.asarray(opac), **kw)
    t = ttiles.bin_gaussians(to_torch_prep(prep),
                             opacities=None if opac is None else torch.tensor(opac), **kw)
    for name in FIELDS:
        got, want = getattr(t, name), np.asarray(getattr(j, name))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert t.max_tiles == j.max_tiles
    return j, t


def scene_prep(n, seed, w, h, scale=1.0, spread=2.0):
    cam = make_camera(w=w, h=h)
    means, scales, quats, colors, opac, _ = random_scene(n, seed=seed, spread=spread)
    prep = jax_prep(jnp.asarray(means), jnp.asarray(scales * scale), jnp.asarray(quats),
                    None, cam["viewmatrix"], cam["projmatrix"], cam["campos"],
                    image_height=h, image_width=w, tanfovx=cam["tanfovx"],
                    tanfovy=cam["tanfovy"], sh_degree=0, tile_size=16,
                    colors_precomp=jnp.asarray(colors))
    return prep, opac


def no_visible(prep, opac):
    return prep._replace(visible=jnp.zeros_like(prep.visible)), opac


def faint_every_third(prep, opac):
    opac = opac.copy()
    opac[::3] = 1e-3      # below ALPHA_EPS: no tile, and no rect position dropped
    return prep, opac


# (scene, binning arguments, what the case must exercise[, an edit of (prep, opacities)])
CASES = {
    "culled": (dict(n=150, seed=1, w=64, h=48),
               dict(grid_x=4, grid_y=3, budget=4096, max_tiles_per_gaussian=32,
                    tile_size=16), "culled"),
    "budget_overflow": (dict(n=120, seed=2, w=64, h=64),
                        dict(grid_x=4, grid_y=4, budget=40, max_tiles_per_gaussian=32,
                             tile_size=16), "dropped"),
    "tmax_overflow": (dict(n=100, seed=3, w=64, h=64),
                      dict(grid_x=4, grid_y=4, budget=4096, max_tiles_per_gaussian=2,
                           tile_size=16), "rect_dropped"),
    "unculled_wide_tmax": (dict(n=60, seed=4, w=160, h=128, scale=3.0, spread=1.2),
                           dict(grid_x=10, grid_y=8, budget=16384,
                                max_tiles_per_gaussian=ttiles.MAX_CULL_TMAX + 32,
                                tile_size=16), "unculled"),
    "unculled_tail": (dict(n=60, seed=4, w=160, h=128, scale=3.0, spread=1.2),
                      dict(grid_x=10, grid_y=8, budget=16384, max_tiles_per_gaussian=8,
                           tile_size=16), "rect_dropped"),
    "empty_view": (dict(n=50, seed=8, w=64, h=48),
                   dict(grid_x=4, grid_y=3, budget=4096, max_tiles_per_gaussian=32,
                        tile_size=16), "empty", no_visible),
    "opacity_below_eps": (dict(n=120, seed=9, w=64, h=64),
                          dict(grid_x=4, grid_y=4, budget=4096, max_tiles_per_gaussian=4,
                               tile_size=16), "faint", faint_every_third),
    # a grid wider and taller than the image's 4 x 3: the tiles past it stay empty, and
    # the small Gaussians near the centre leave the first tile empty too
    "empty_end_tiles": (dict(n=40, seed=10, w=64, h=48, scale=0.2, spread=0.4),
                        dict(grid_x=6, grid_y=5, budget=4096, max_tiles_per_gaussian=32,
                             tile_size=16), "ends_empty"),
}


@pytest.mark.parametrize("with_opacity", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_gaussians_matches_jax_exactly(case, with_opacity):
    scene, kw, expect, *edit = CASES[case]
    prep, opac = scene_prep(**scene)
    for fn in edit:
        prep, opac = fn(prep, opac)
    j, t = bin_both(prep, opac if with_opacity else None, **kw)
    if expect == "empty":
        assert int(t.num_instances) == 0 and not t.tile_start.any()
        assert (t.gauss_id == scene["n"]).all() and (t.presort_slot == kw["budget"]).all()
    elif expect == "faint":
        assert int(t.rect_dropped) > 0
        if with_opacity:
            counts = t.gauss_offsets[1:] - t.gauss_offsets[:-1]
            assert not counts[::3].any() and counts.any()
    elif expect == "ends_empty":
        num = int(t.num_instances)
        assert num > 0 and int(t.tile_start[1]) == 0
        assert int(t.tile_start[-2]) == int(t.tile_start[-1]) == num
    elif expect == "dropped":
        assert int(t.dropped) > 0 and int(t.num_instances) == kw["budget"]
    elif expect == "rect_dropped":
        assert int(t.rect_dropped) > 0
    elif expect == "unculled":
        assert kw["max_tiles_per_gaussian"] > ttiles.MAX_CULL_TMAX
        assert int(t.num_instances) > 0
    else:
        assert int(t.dropped) == 0 and int(t.num_instances) > 0
    # the count probe predicts the binning's production
    cnt = ttiles.instance_counts(
        to_torch_prep(prep), tile_size=kw["tile_size"],
        tmax=kw["max_tiles_per_gaussian"],
        opacities=torch.tensor(opac) if with_opacity else None)
    jcnt = jax_counts(
        prep, tile_size=kw["tile_size"], tmax=kw["max_tiles_per_gaussian"],
        opacities=jnp.asarray(opac) if with_opacity else None)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_unculled_without_tile_size_matches_jax():
    prep, opac = scene_prep(n=100, seed=6, w=64, h=48)
    bin_both(prep, opac, grid_x=4, grid_y=3, budget=4096, max_tiles_per_gaussian=16)


@pytest.mark.parametrize("tmax", [8, 96])
def test_tile_pass_mask_matches_jax_bits(tmax):
    """The port keeps the pass mask as bools; the JAX package packs the same bits into
    uint32 words (bit j of word j // 32)."""
    prep, opac = scene_prep(n=80, seed=7, w=160, h=128, scale=3.0, spread=1.2)
    opac = opac.copy()
    opac[:5] = 1e-9    # below ALPHA_EPS: culled outright
    jmask = np.asarray(jax_mask(prep, tile_size=16, tmax=tmax,
                                opacities=jnp.asarray(opac)))
    bits = (jmask[:, np.arange(tmax) // 32] >> (np.arange(tmax) % 32)) & 1
    tmask = ttiles.tile_pass_mask(to_torch_prep(prep), tile_size=16, tmax=tmax,
                                  opacities=torch.tensor(opac))
    np.testing.assert_array_equal(tmask.numpy(), bits.astype(bool))
    assert not tmask[:5].any()


def test_cpu_tensors_launch_no_kernel():
    """On CPU tensors bin_gaussians and instance_counts take the plain version: no
    `launches.bin_*` counter moves, and the buffer is the plain version's."""
    from langsplat_tpu_torch.ops import _build
    prep, opac = scene_prep(n=60, seed=11, w=64, h=48)
    tprep, topac = to_torch_prep(prep), torch.tensor(opac)
    kw = dict(grid_x=4, grid_y=3, budget=4096, max_tiles_per_gaussian=32, tile_size=16)
    before = dict(_build.LAUNCHES)
    inst = ttiles.bin_gaussians(tprep, opacities=topac, **kw)
    counts = ttiles.instance_counts(tprep, tile_size=16, tmax=32, opacities=topac)
    assert dict(_build.LAUNCHES) == before
    assert {k for k in before if k.startswith("bin_")} == {
        "bin_count", "bin_rank", "bin_emit", "bin_sort", "bin_ranges"}
    plain = ttiles.bin_gaussians_plain(tprep, opacities=topac, **kw)
    for name in FIELDS:
        assert torch.equal(getattr(inst, name), getattr(plain, name)), name
    assert int(counts.sum()) == int(inst.num_instances) > 0
