"""PyTorch port, tile blend: the plain version of `rasterize` against the JAX
Pallas blend (interpret mode) and the dense oracle. (The CUDA kernel is held against the
plain version in tests/test_torch_cuda.py.)

Tolerance: 3e-5 absolute, the tolerance of the JAX package's own Pallas-vs-dense test
(the Pallas kernel takes the transmittance as exp(cumsum(log(1 - alpha)))).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.ops.rasterize_pallas import rasterize_pallas
from langsplat_tpu.ops.rasterize_reference import rasterize_dense
from langsplat_tpu_torch.ops import _build, rasterize_cuda
from langsplat_tpu_torch.ops.projection import PreprocessOut
from langsplat_tpu_torch.ops.tiles import InstanceBuffer

from tests.test_projection_and_dense import make_camera
from tests.test_tiles import random_scene
from tests.test_torch_tiles import jax_bin, jax_prep

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 3e-5


def jax_scene(n, seed, w, h, budget, tmax, ts=16):
    cam = make_camera(w=w, h=h)
    means, scales, quats, colors, opac, feats = random_scene(n, seed=seed)
    prep = jax_prep(jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats), None,
                    cam["viewmatrix"], cam["projmatrix"], cam["campos"], image_height=h,
                    image_width=w, tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
                    sh_degree=0, tile_size=ts, colors_precomp=jnp.asarray(colors))
    inst = jax_bin(prep, grid_x=-(-w // ts), grid_y=-(-h // ts), budget=budget,
                   max_tiles_per_gaussian=tmax)
    return prep, inst, opac, feats


def to_torch(prep, inst, device="cpu"):
    tprep = PreprocessOut(*(torch.tensor(np.asarray(x), device=device) for x in prep))
    tinst = InstanceBuffer(**{k: torch.tensor(np.asarray(getattr(inst, k)), device=device)
                              for k in ("gauss_id", "tile_id", "tile_start",
                                        "num_instances", "dropped", "rect_dropped",
                                        "presort_slot", "gauss_offsets")},
                           max_tiles=inst.max_tiles)
    return tprep, tinst


# name -> (scene, bg, with features); the scenes of tests/test_pallas_blend.py
SCENES = {
    "dense": (dict(n=120, seed=3, w=64, h=48, budget=8192, tmax=64),
              [0.1, 0.3, 1.0], True),
    "rgb_only": (dict(n=120, seed=9, w=64, h=48, budget=8192, tmax=64),
                 [0.0, 0.0, 0.0], False),
    "odd_tile_count": (dict(n=60, seed=13, w=48, h=16, budget=2048, tmax=16),
                       [0.5, 0.1, 0.2], True),
    "white_bg": (dict(n=120, seed=9, w=64, h=48, budget=8192, tmax=64),
                 [1.0, 1.0, 1.0], True),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_plain_blend_matches_pallas_and_dense(name):
    scene, bg, with_feat = SCENES[name]
    prep, inst, opac, feats = jax_scene(**scene)
    w, h = scene["w"], scene["h"]
    fj = jnp.asarray(feats) if with_feat else None
    pall = rasterize_pallas(prep, inst, jnp.asarray(opac), fj, jnp.asarray(bg),
                            image_height=h, image_width=w, tile_size=16, chunk=32,
                            interpret=True)
    dense = rasterize_dense(prep, jnp.asarray(opac), fj, jnp.asarray(bg),
                            image_height=h, image_width=w, tile_size=16)
    tprep, tinst = to_torch(prep, inst)
    launches = _build.LAUNCHES["blend_fwd"]
    out = rasterize_cuda.rasterize(
        tprep, tinst, torch.tensor(opac), torch.tensor(feats) if with_feat else None,
        torch.tensor(bg, dtype=torch.float32), image_height=h, image_width=w,
        tile_size=16)
    assert _build.LAUNCHES["blend_fwd"] == launches   # CPU tensors: the plain version
    keys = ["render", "final_transmittance"] + (["language_feature_image"]
                                                if with_feat else [])
    assert sorted(out) == sorted(keys)
    for ref in (pall, dense):
        for k in keys:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=ATOL,
                                       err_msg=k)


def test_cuda_wrapper_refuses_cpu_tensors():
    prep, inst, opac, feats = jax_scene(**SCENES["dense"][0])
    tprep, tinst = to_torch(prep, inst)
    args = rasterize_cuda.blend_args(tprep, tinst, torch.tensor(opac),
                                     torch.tensor(feats), torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_cuda.blend_forward_cuda(*args, image_height=48, image_width=64,
                                          tile_size=16)


@pytest.mark.parametrize("tile_size", [None, 16])
def test_dense_oracle_matches_jax(tile_size):
    from langsplat_tpu_torch.ops.rasterize_reference import rasterize_dense as t_dense
    prep, inst, opac, feats = jax_scene(**SCENES["dense"][0])
    bg = [0.3, 0.2, 0.1]
    ref = rasterize_dense(prep, jnp.asarray(opac), jnp.asarray(feats), jnp.asarray(bg),
                          image_height=48, image_width=64, tile_size=tile_size)
    tprep, _ = to_torch(prep, inst)
    out = t_dense(tprep, torch.tensor(opac), torch.tensor(feats), torch.tensor(bg),
                  image_height=48, image_width=64, tile_size=tile_size)
    for k in ("render", "final_transmittance", "language_feature_image"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=ATOL,
                                   err_msg=k)
