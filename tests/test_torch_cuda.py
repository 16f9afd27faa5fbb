"""PyTorch port on the card: the CUDA blend kernel against its plain PyTorch version, and
the whole render on the card against the same render on the CPU.

Every test here needs a CUDA device; each one decides that in the `cuda_device` fixture
and skips without one. This file imports only torch, numpy and the port, so it runs on
a machine where the JAX package's tests do not:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: 2e-4 absolute. The kernel and the plain version make the same sequential
transmittance steps, but may round differently (FMA contraction, expf); when T lands
next to 1e-4 that can flip which instance ends a pixel, and such a flip moves a channel
by at most ~1e-4.
"""

import numpy as np
import pytest
import torch

from langsplat_tpu_torch.core import transforms
from langsplat_tpu_torch.ops import _build, projection, rasterize_cuda, tiles
from langsplat_tpu_torch.ops.render import RenderSettings, render

CARD_ATOL = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def camera(w, h, fov=0.8):
    """Camera at the origin looking down +z (row-vector matrices, numpy)."""
    view = transforms.world_to_view(np.eye(3), np.zeros(3)).T
    proj = transforms.projection_matrix(0.01, 100.0, fov, fov).T
    return dict(viewmatrix=view, projmatrix=view @ proj,
                campos=np.linalg.inv(view)[3, :3].astype(np.float32),
                tanfovx=float(np.tan(fov / 2)), tanfovy=float(np.tan(fov / 2)))


def scene(n, seed, num_feat):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, max(num_feat, 1)))
    arrays = dict(
        means=np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(3, 9, (n, 1))], 1),
        scales=np.exp(rng.uniform(np.log(0.05), np.log(0.5), (n, 3))),
        quats=rng.normal(size=(n, 4)), colors=rng.uniform(size=(n, 3)),
        opac=rng.uniform(0.2, 0.95, n),
        feats=(feats / np.linalg.norm(feats, axis=1, keepdims=True))[:, :num_feat])
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def binned(n, seed, w, h, num_feat, device, ts=16):
    s = {k: torch.tensor(v, device=device) for k, v in scene(n, seed, num_feat).items()}
    cam = camera(w, h)
    prep = projection.preprocess(
        s["means"], s["scales"], s["quats"], None,
        *(torch.tensor(cam[k], device=device) for k in ("viewmatrix", "projmatrix",
                                                        "campos")),
        image_height=h, image_width=w, tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
        sh_degree=0, tile_size=ts, colors_precomp=s["colors"])
    inst = tiles.bin_gaussians(prep, grid_x=-(-w // ts), grid_y=-(-h // ts),
                               budget=64 * n, max_tiles_per_gaussian=64, tile_size=ts,
                               opacities=s["opac"])
    return prep, inst, s["opac"], (s["feats"] if num_feat else None)


@pytest.mark.cuda
@pytest.mark.parametrize("num_feat", [0, 3])
@pytest.mark.parametrize("n,seed,w,h", [(300, 0, 64, 48), (500, 1, 77, 53),
                                        (3000, 2, 200, 129)])
def test_kernel_matches_plain(cuda_device, num_feat, n, seed, w, h):
    prep, inst, opac, feats = binned(n, seed, w, h, num_feat, cuda_device)
    assert int(inst.dropped) == 0
    bg = torch.tensor([0.2, 0.5, 0.9], device=cuda_device)
    args = rasterize_cuda.blend_args(prep, inst, opac, feats, bg)
    size = dict(image_height=h, image_width=w, tile_size=16)
    launches = _build.LAUNCHES["blend_fwd"]
    image, t_final = rasterize_cuda.blend_forward(*args, **size)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["blend_fwd"] == launches + 1
    ref_image, ref_t = rasterize_cuda.blend_forward_plain(*args, **size)
    assert image.shape == (3 + num_feat, h, w) and t_final.shape == (h, w)
    assert bool(torch.isfinite(image).all())
    torch.testing.assert_close(image, ref_image, atol=CARD_ATOL, rtol=0)
    torch.testing.assert_close(t_final, ref_t, atol=CARD_ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    prep, inst, opac, feats = binned(100, 3, 64, 48, 3, cuda_device)
    bg = torch.zeros(3, device=cuda_device)
    args = rasterize_cuda.blend_args(prep, inst, opac, feats, bg)
    with pytest.raises(ValueError, match="tile_size"):
        rasterize_cuda.blend_forward_cuda(*args, image_height=48, image_width=64,
                                          tile_size=8)
    wide = torch.zeros((opac.shape[0], rasterize_cuda.MAX_FEATURES + 1),
                       device=cuda_device)
    with pytest.raises(ValueError, match="feature"):
        rasterize_cuda.blend_forward_cuda(
            *rasterize_cuda.blend_args(prep, inst, opac, wide, bg),
            image_height=48, image_width=64, tile_size=16)
    with pytest.raises(ValueError, match="dtype"):
        rasterize_cuda.blend_forward_cuda(*args[:2], opac.double(), *args[3:],
                                          image_height=48, image_width=64, tile_size=16)


@pytest.mark.cuda
def test_render_on_card_matches_cpu(cuda_device):
    """The whole render (SH colors, binning, kernel) on the card against the same
    render on the CPU (plain blend)."""
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    rng = np.random.default_rng(4)
    n, w, h = 2000, 160, 120
    s = scene(n, 4, 3)
    params = dict(xyz=s["means"], features_dc=rng.normal(size=(n, 1, 3)),
                  features_rest=0.3 * rng.normal(size=(n, 15, 3)),
                  scaling=np.log(s["scales"]), rotation=s["quats"],
                  opacity=rng.normal(size=(n, 1)), language_feature=s["feats"],
                  alive=np.ones(n, bool))
    cam = camera(w, h)
    settings = RenderSettings(image_height=h, image_width=w, tanfovx=cam["tanfovx"],
                              tanfovy=cam["tanfovy"], sh_degree=3, budget=64 * n)
    outs = {}
    for dev in ("cpu", cuda_device):
        mats = [torch.tensor(cam[k], device=dev) for k in ("viewmatrix", "projmatrix",
                                                           "campos")]
        outs[str(dev)] = render(from_numpy(params, dev), settings, *mats,
                                torch.ones(3, device=dev))
    # Preprocess rounds differently on the card, which can move a tile-rect edge by one
    # tile where a radius lands on an integer, and so cut or keep that Gaussian's 3-sigma
    # tail (alpha <= 0.99 e^-4.5 ~ 0.011) in a few pixels: those few may differ by more.
    for k in ("render", "language_feature_image", "final_transmittance"):
        err = (outs["cuda"][k].cpu() - outs["cpu"][k]).abs()
        assert float(err.max()) < 0.011, k
        assert float((err > CARD_ATOL).float().mean()) < 1e-3, k
    assert int(outs["cuda"]["instances_dropped"]) == 0
    assert int(outs["cuda"]["visibility_filter"].sum()) > n // 2
