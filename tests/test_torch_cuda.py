"""PyTorch port on the card: the CUDA kernels (blend forward, blend backward, segment
sum, projection and SH forward and backward, SSIM forward and backward, binning, Adam)
against their plain PyTorch versions, and the whole render and one training step of each
phase on the card against the same on the CPU.

Every test here needs a CUDA device; each one decides that in the `cuda_device` fixture
and skips without one. This file imports only torch, numpy, the port and (for the
benchmark cells' fields) `bench_port`, so it runs on a machine where the JAX package's
tests do not:

    python -m pytest -m cuda tests/test_torch_cuda.py

The overflow paths (render_full's retries, truncated instance buffers, the kernels'
writes checked with guard words, an empty view) run in child processes with
CUDA_LAUNCH_BLOCKING=1: a device-side assertion would end the context of the process
that hits it, and the variable only acts when it is set before CUDA starts.

Tolerance: 2e-4 absolute. The kernel and the plain version make the same sequential
transmittance steps, but may round differently (FMA contraction, expf); when T lands
next to 1e-4 that can flip which instance ends a pixel, and such a flip moves a channel
by at most ~1e-4.
"""

import os
import subprocess
import sys
import traceback
import warnings
from pathlib import Path
from types import SimpleNamespace

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


def residuals(image, t_final, bg, seed):
    """Random image and transmittance gradients, and the backward's residuals."""
    gen = torch.Generator(device=image.device).manual_seed(seed)
    g_image = torch.randn(image.shape, generator=gen, device=image.device)
    g_t = torch.randn(t_final.shape, generator=gen, device=image.device)
    g_tfinal, total = rasterize_cuda.backward_residuals(image, t_final, bg, g_image, g_t)
    return g_image, g_tfinal, total


@pytest.mark.cuda
@pytest.mark.parametrize("num_feat,grad_mode", [(0, "full"), (3, "full"),
                                                (3, "feature")])
@pytest.mark.parametrize("n,seed,w,h", [(500, 1, 77, 53), (3000, 2, 200, 129)])
def test_backward_kernel_matches_plain(cuda_device, num_feat, grad_mode, n, seed, w, h):
    """K2 against the plain backward on the same inputs; its replayed final T equals
    K1's bit for bit. Tolerance: 1e-4 of each row's largest magnitude (the kernel sums
    each instance's 256 pixels in another order than the plain version)."""
    prep, inst, opac, feats = binned(n, seed, w, h, num_feat, cuda_device)
    bg = torch.tensor([0.2, 0.5, 0.9], device=cuda_device)
    args = rasterize_cuda.blend_args(prep, inst, opac, feats, bg)
    size = dict(image_height=h, image_width=w, tile_size=16)
    image, t_final = rasterize_cuda.blend_forward(*args, **size)
    g_image, g_tfinal, total = residuals(image, t_final, bg, seed)
    bwd_args = (*args[:8], inst.presort_slot, g_image, g_tfinal, total, t_final)
    launches = _build.LAUNCHES["blend_bwd"]
    d_pre, t_replay = rasterize_cuda.blend_backward(*bwd_args, grad_mode=grad_mode,
                                                    return_t=True, **size)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["blend_bwd"] == launches + 1
    assert torch.equal(t_replay, t_final)
    ref, ref_t = rasterize_cuda.blend_backward_plain(*bwd_args, grad_mode=grad_mode,
                                                     return_t=True, **size)
    assert d_pre.shape == ref.shape == (rasterize_cuda.grad_rows(num_feat, grad_mode),
                                        inst.gauss_id.shape[0])
    assert bool(torch.isfinite(d_pre).all()) and float(ref.abs().max()) > 0
    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-6)
    assert float(((d_pre - ref).abs() / scale).max()) < 1e-4


@pytest.mark.cuda
def test_segsum_kernel_matches_plain(cuda_device):
    """K3 against the plain segment sum on the CPU, with empty segments and segments
    longer than 32. The CPU version adds each segment's columns in ascending order, as
    the kernel does (on the card the plain version's index_add_ adds in the order its
    atomics land). Tolerance 1e-5 absolute (sums of at most 100 values of order 1)."""
    from langsplat_tpu_torch.ops.segsum import segment_sum, segment_sum_plain
    rng = np.random.default_rng(0)
    lengths = rng.integers(0, 4, 5000)
    lengths[rng.uniform(size=5000) < 0.3] = 0
    lengths[[7, 1234, 4999]] = [33, 100, 64]
    ends = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    d_pre = torch.tensor(rng.normal(size=(12, int(ends[-1]) + 17)).astype(np.float32),
                         device=cuda_device)
    ends_t = torch.tensor(ends, device=cuda_device)
    launches = _build.LAUNCHES["segsum"]
    out = segment_sum(d_pre, ends_t, 5000)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["segsum"] == launches + 1
    torch.testing.assert_close(out.cpu(), segment_sum_plain(d_pre.cpu(), ends_t.cpu(),
                                                            5000), atol=1e-5, rtol=0)


def reset_field(n, seed, w, h, num_feat, device, ts=16):
    """Screen-space blend inputs of a field just after an opacity reset: opacities
    0.005-0.02 and sigmas of 10-30 px (rotated ellipses), binned uncut, as the
    training path bins rects past the culled tile cap."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-10, w + 10, n), rng.uniform(-10, h + 10, n)], 1)
    major, minor = rng.uniform(10, 30, n), rng.uniform(10, 30, n)
    minor = np.minimum(minor, major)
    theta = rng.uniform(0, np.pi, n)
    cos, sin = np.cos(theta), np.sin(theta)
    cxx = major ** 2 * cos ** 2 + minor ** 2 * sin ** 2
    cyy = major ** 2 * sin ** 2 + minor ** 2 * cos ** 2
    cxy = (major ** 2 - minor ** 2) * cos * sin
    det = cxx * cyy - cxy ** 2
    radius = np.ceil(3 * major)
    grid_x, grid_y = -(-w // ts), -(-h // ts)
    tmin = np.stack([np.clip((means[:, 0] - radius) // ts, 0, grid_x),
                     np.clip((means[:, 1] - radius) // ts, 0, grid_y)], 1)
    tmax = np.stack([np.clip((means[:, 0] + radius + ts - 1) // ts, 0, grid_x),
                     np.clip((means[:, 1] + radius + ts - 1) // ts, 0, grid_y)], 1)
    visible = (tmax - tmin).prod(axis=1) > 0
    feats = rng.normal(size=(n, max(num_feat, 1)))
    arrays = dict(means2d=means, depths=rng.uniform(1, 10, n),
                  conics=np.stack([cyy / det, -cxy / det, cxx / det], 1),
                  radii=np.where(visible, radius, 0).astype(np.int32),
                  colors=rng.uniform(size=(n, 3)), tiles_min=tmin.astype(np.int32),
                  tiles_max=tmax.astype(np.int32), visible=visible)
    prep = projection.PreprocessOut(*(
        torch.tensor(arrays[k] if arrays[k].dtype in (np.int32, bool)
                     else arrays[k].astype(np.float32), device=device)
        for k in projection.PreprocessOut._fields))
    inst = tiles.bin_gaussians(prep, grid_x=grid_x, grid_y=grid_y,
                               budget=n * grid_x * grid_y,
                               max_tiles_per_gaussian=grid_x * grid_y, tile_size=ts,
                               cull=False)
    opac = torch.tensor(rng.uniform(0.005, 0.02, n).astype(np.float32), device=device)
    feats = (feats / np.linalg.norm(feats, axis=1, keepdims=True))[:, :num_feat]
    return prep, inst, opac, (torch.tensor(feats.astype(np.float32), device=device)
                              if num_feat else None)


def backward_args(prep, inst, opac, feats, w, h, seed, device):
    bg = torch.tensor([0.2, 0.5, 0.9], device=device)
    args = rasterize_cuda.blend_args(prep, inst, opac, feats, bg)
    image, t_final = rasterize_cuda.blend_forward(*args, image_height=h, image_width=w,
                                                  tile_size=16)
    g_image, g_tfinal, total = residuals(image, t_final, bg, seed)
    return (*args[:8], inst.presort_slot, g_image, g_tfinal, total, t_final)


@pytest.mark.cuda
@pytest.mark.parametrize("num_feat,grad_mode", [(0, "full"), (3, "full"),
                                                (3, "feature")])
def test_backward_kernel_on_an_opacity_reset_field(cuda_device, num_feat, grad_mode):
    """K2 against the plain backward where its cull skips most (instance, warp) pairs:
    low opacities, large sigmas, uncut binning; replayed T bit-equal to K1's."""
    w, h = 200, 129
    prep, inst, opac, feats = reset_field(400, 8, w, h, num_feat, cuda_device)
    assert int(inst.dropped) == 0 and int(inst.rect_dropped) == 0
    bwd_args = backward_args(prep, inst, opac, feats, w, h, 8, cuda_device)
    size = dict(image_height=h, image_width=w, tile_size=16, grad_mode=grad_mode)
    d_pre, t_replay = rasterize_cuda.blend_backward(*bwd_args, return_t=True, **size)
    torch.cuda.synchronize()
    assert torch.equal(t_replay, bwd_args[-1])
    ref = rasterize_cuda.blend_backward_plain(*bwd_args, **size)
    scale = ref.abs().amax(dim=1, keepdim=True)
    assert bool((scale > 0).all())
    assert float(((d_pre - ref).abs() / scale).max()) < 1e-4
    keep = rasterize_cuda.warp_region_keep(
        prep.means2d, prep.conics, opac, prep.visible, inst.gauss_id, inst.tile_id,
        grid_x=-(-w // 16))[:int(inst.num_instances)]
    assert float(keep.float().mean()) < 0.5     # the cull skips most pairs here


def reset_field_with_opaque(seed, w, h, num_feat, device):
    """`reset_field` with one Gaussian in ten made opaque (0.97), so that some pixels
    end; blend_forward's arguments for it, and its instance buffer."""
    prep, inst, opac, feats = reset_field(400, seed, w, h, num_feat, device)
    opac = opac.clone()
    opac[::10] = 0.97
    bg = torch.tensor([0.2, 0.5, 0.9], device=device)
    return prep, inst, opac, rasterize_cuda.blend_args(prep, inst, opac, feats, bg)


@pytest.mark.cuda
@pytest.mark.parametrize("num_feat", [0, 3])
def test_forward_kernel_on_an_opacity_reset_field(cuda_device, num_feat):
    """K1 against the plain forward where its warp-region cull skips most (instance,
    warp) pairs: low opacities, large sigmas, uncut binning, and a few opaque Gaussians
    so that some pixels end (their final T compared too). 2e-4 absolute, as above."""
    w, h = 200, 129
    prep, inst, opac, args = reset_field_with_opaque(8, w, h, num_feat, cuda_device)
    assert int(inst.dropped) == 0 and int(inst.rect_dropped) == 0
    size = dict(image_height=h, image_width=w, tile_size=16)
    launches = _build.LAUNCHES["blend_fwd"]
    image, t_final = rasterize_cuda.blend_forward(*args, **size)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["blend_fwd"] == launches + 1
    ref_image, ref_t, evaluated, _, _ = rasterize_cuda._blend_plain(*args, **size)
    # a pixel ended where it evaluated fewer instances than its tile lists
    counts = (inst.tile_start[1:] - inst.tile_start[:-1]).to(torch.int64)
    tile_counts = rasterize_cuda._to_image(counts[:, None, None].expand(-1, 1, 256), h, w,
                                           16)[0]
    ended = evaluated < tile_counts
    assert int(ended.sum()) > 0
    assert bool(torch.isfinite(image).all())
    torch.testing.assert_close(image, ref_image, atol=CARD_ATOL, rtol=0)
    torch.testing.assert_close(t_final, ref_t, atol=CARD_ATOL, rtol=0)
    torch.testing.assert_close(t_final[ended], ref_t[ended], atol=CARD_ATOL, rtol=0)
    keep = rasterize_cuda.warp_region_keep(
        prep.means2d, prep.conics, opac, prep.visible, inst.gauss_id, inst.tile_id,
        grid_x=-(-w // 16))[:int(inst.num_instances)]
    assert float(keep.float().mean()) < 0.5     # the cull skips most pairs here


@pytest.mark.cuda
def test_forward_kernel_is_deterministic(cuda_device):
    """K1's image and final T are bit-equal over two launches."""
    w, h = 200, 129
    _, _, _, args = reset_field_with_opaque(9, w, h, 3, cuda_device)
    size = dict(image_height=h, image_width=w, tile_size=16)
    image, t_final = rasterize_cuda.blend_forward_cuda(*args, **size)
    image2, t_final2 = rasterize_cuda.blend_forward_cuda(*args, **size)
    assert float((1.0 - t_final).max()) > 0.5
    assert torch.equal(image, image2) and torch.equal(t_final, t_final2)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_mode", ["full", "feature"])
def test_backward_and_segsum_kernels_are_deterministic(cuda_device, grad_mode):
    """K2's d_pre and K3's sums are bit-equal over two launches (fixed-order
    reductions, no atomics)."""
    from langsplat_tpu_torch.ops.segsum import segment_sum_cuda
    w, h = 200, 129
    prep, inst, opac, feats = reset_field(400, 9, w, h, 3, cuda_device)
    bwd_args = backward_args(prep, inst, opac, feats, w, h, 9, cuda_device)
    size = dict(image_height=h, image_width=w, tile_size=16, grad_mode=grad_mode)
    first = rasterize_cuda.blend_backward_cuda(*bwd_args, **size)
    second = rasterize_cuda.blend_backward_cuda(*bwd_args, **size)
    assert float(first.abs().max()) > 0 and torch.equal(first, second)
    ends = torch.clamp(inst.gauss_offsets, 0, inst.gauss_id.shape[0]).contiguous()
    n = prep.means2d.shape[0]
    assert torch.equal(segment_sum_cuda(first, ends, n), segment_sum_cuda(first, ends, n))


@pytest.mark.cuda
def test_segsum_kernel_long_unaligned_and_empty_segments(cuda_device):
    """K3 with a segment longer than its shared-memory chunk (6001 columns), spans that
    start at unaligned columns in rows whose width is odd, a block of only empty
    segments, and empty segments at both ends, against the plain sum on the CPU
    (1e-5 of each row's largest sum)."""
    from langsplat_tpu_torch.ops.segsum import segment_sum_cuda, segment_sum_plain
    rng = np.random.default_rng(12)
    n = 3000
    lengths = rng.integers(0, 20, n)
    lengths[:5] = 0
    lengths[-5:] = 0
    lengths[600:900] = 0            # block 2 and part of 3: nothing at all
    lengths[1300] = 6001
    ends = (7 + np.concatenate([[0], np.cumsum(lengths)])).astype(np.int32)
    width = int(ends[-1]) + 5
    assert width % 2 == 1
    for rows in (9, 3, 17):
        d_pre = torch.tensor(rng.normal(size=(rows, width)).astype(np.float32),
                             device=cuda_device)
        ends_t = torch.tensor(ends, device=cuda_device)
        out = segment_sum_cuda(d_pre, ends_t, n).cpu()
        ref = segment_sum_plain(d_pre.cpu(), ends_t.cpu(), n)
        assert out.shape == (rows, n)
        assert bool((out[:, lengths == 0] == 0).all())
        scale = ref.abs().amax(dim=1, keepdim=True)
        assert float(((out - ref).abs() / scale).max()) <= 1e-5, rows


def field_params(n, seed, num_feat):
    rng = np.random.default_rng(seed)
    s = scene(n, seed, max(num_feat, 1))
    return dict(xyz=s["means"], features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
                features_rest=(0.3 * rng.normal(size=(n, 15, 3))).astype(np.float32),
                scaling=np.log(s["scales"]), rotation=s["quats"],
                opacity=rng.normal(size=(n, 1)).astype(np.float32),
                language_feature=s["feats"] if num_feat else None,
                alive=np.ones(n, bool))


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["rgb", "feature"])
def test_train_step_on_card_matches_cpu(cuda_device, phase):
    """One training step's loss and gradients on the card (K1, K2, K3) against the same
    step on the CPU (plain versions). As in test_render_on_card_matches_cpu, preprocess
    rounding may move a tile-rect edge, so a few gradient entries may differ more."""
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    from langsplat_tpu_torch.train import trainer
    n, w, h = 2000, 160, 120
    num_feat = 3 if phase == "feature" else 0
    params = field_params(n, 6, num_feat)
    cam = camera(w, h)
    settings = RenderSettings(image_height=h, image_width=w, tanfovx=cam["tanfovx"],
                              tanfovy=cam["tanfovy"], sh_degree=3, budget=64 * n,
                              include_feature=bool(num_feat),
                              grad_mode="feature" if num_feat else "full")
    rng = np.random.default_rng(7)
    gt = rng.uniform(size=(3, h, w)).astype(np.float32)
    mask = (rng.uniform(size=(1, h, w)) < 0.8).astype(np.float32)
    outs = {}
    for dev in ("cpu", cuda_device):
        field = from_numpy(params, dev)
        mats = [torch.tensor(cam[k], device=dev) for k in ("viewmatrix", "projmatrix",
                                                           "campos")]
        bg = torch.zeros(3, device=dev)
        launches = dict(_build.LAUNCHES)
        if num_feat:
            loss, _, grads = trainer.feature_loss_and_grads(
                field, *mats, torch.tensor(gt, device=dev), torch.tensor(mask, device=dev),
                bg, settings=settings)
        else:
            loss, _, _, grads, tap = trainer.rgb_loss_and_grads(
                field, *mats, torch.tensor(gt, device=dev), bg, settings=settings,
                lambda_dssim=0.2)
            grads["tap"] = tap
        if dev != "cpu":
            torch.cuda.synchronize()
            for k in ("blend_fwd", "blend_bwd", "segsum"):
                assert _build.LAUNCHES[k] == launches[k] + 1, k
        outs[str(dev)] = (float(loss), {k: v.cpu() for k, v in grads.items()})
    (loss_c, grads_c), (loss_g, grads_g) = outs["cpu"], outs["cuda"]
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-4)
    for k, ref in grads_c.items():
        scale = float(ref.abs().max())
        assert scale > 0, k
        err = (grads_g[k] - ref).abs()
        assert float((err > 1e-3 * scale).float().mean()) < 1e-3, k


@pytest.mark.cuda
@pytest.mark.parametrize("grad_mode", ["full", "feature"])
def test_tiled_backend_on_card(cuda_device, grad_mode):
    """The tiled backend (`ops/rasterize_tiled.py`, plain PyTorch) on the card: its
    image within CARD_ATOL of the forward kernel's where no tile is truncated, and its
    gradients bit-equal over two runs, reduced through the segment-sum kernel (K3), and
    within 5e-5 of the plain blend's gradients on the CPU."""
    from langsplat_tpu_torch.ops.rasterize_tiled import rasterize_tiled, truncated_tiles
    w, h = 77, 53
    prep, inst, opac, feats = binned(500, 1, w, h, 3, cuda_device)
    assert truncated_tiles(inst, 1024) == 0
    size = dict(image_height=h, image_width=w, tile_size=16)
    bg = torch.tensor([0.3, 0.1, 0.6], device=cuda_device)

    def grads(blend, device):
        xs = [x.detach().to(device).requires_grad_(True)
              for x in (prep.means2d, prep.conics, opac, prep.colors, feats)]
        p = projection.PreprocessOut(*(t.to(device) for t in prep))._replace(
            means2d=xs[0], conics=xs[1], colors=xs[3])
        i = tiles.InstanceBuffer(**{k: getattr(inst, k).to(device) for k in (
            "gauss_id", "tile_id", "tile_start", "num_instances", "dropped",
            "rect_dropped", "presort_slot", "gauss_offsets")}, max_tiles=inst.max_tiles)
        out = blend(p, i, xs[2], xs[4], bg.to(device), grad_mode=grad_mode, **size)
        loss = ((out["language_feature_image"] - 0.3) ** 2).mean()
        if grad_mode == "full":
            loss = loss + (out["render"] ** 2).mean() + out["final_transmittance"].mean()
        wrt = xs[4:] if grad_mode == "feature" else xs
        return out, torch.autograd.grad(loss, wrt)

    def tiled(*args, **kw):
        return rasterize_tiled(*args, max_per_tile=1024, **kw)

    launches = dict(_build.LAUNCHES)
    out, first = grads(tiled, cuda_device)
    _, second = grads(tiled, cuda_device)
    assert _build.LAUNCHES["segsum"] == launches["segsum"] + 2
    assert _build.LAUNCHES["blend_fwd"] == launches["blend_fwd"]
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    ref_out, ref = grads(rasterize_cuda.rasterize, "cpu")
    for a, b in zip(first, ref):
        assert float((a.cpu() - b).abs().max()) <= 5e-5
    image, t_final = rasterize_cuda.blend_forward_cuda(
        *rasterize_cuda.blend_args(prep, inst, opac, feats, bg), **size)
    assert float((out["render"].detach() - image[:3]).abs().max()) <= CARD_ATOL
    assert float((out["final_transmittance"].detach() - t_final).abs().max()) <= CARD_ATOL


@pytest.mark.cuda
def test_collectives_on_card_tensors(cuda_device):
    """collectives.py on CUDA tensors: 2 gloo ranks sharing the card, each collective
    and the differentiable all-gather's backward against the CPU arithmetic."""
    from langsplat_tpu_torch.parallel import launch, runner

    outs = launch.spawn(runner.run, ([("collectives_check", {"rows": 16, "cols": 7})],),
                        2, device_type="cuda", backend="gloo", run_timeout=240)
    for r, (out,) in enumerate(outs):
        assert (out["world"], out["backend"]) == (2, "gloo")
        assert out["device"].startswith("cuda"), out["device"]
        assert max(out["errors"].values()) <= 1e-5, (r, out["errors"])


# ---------------------------------------------------------------------------
# Projection and SH: the kernels of csrc/preprocess.cu against the plain version
# ---------------------------------------------------------------------------

def rotated_camera(w, h, fov=0.8):
    """A camera with a generic rotation and translation (row-vector matrices, numpy)."""
    q = np.array([0.98, 0.1, -0.15, 0.05])
    q = q / np.linalg.norm(q)
    a, b, c, d = q
    rot = np.array([[1 - 2 * (c * c + d * d), 2 * (b * c - a * d), 2 * (b * d + a * c)],
                    [2 * (b * c + a * d), 1 - 2 * (b * b + d * d), 2 * (c * d - a * b)],
                    [2 * (b * d - a * c), 2 * (c * d + a * b), 1 - 2 * (b * b + c * c)]])
    view = transforms.world_to_view(rot, np.array([0.2, -0.1, 0.5])).T
    fov_y = fov * h / w
    proj = transforms.projection_matrix(0.01, 100.0, fov, fov_y).T
    return dict(viewmatrix=view, projmatrix=(view @ proj).astype(np.float32),
                campos=np.linalg.inv(view)[3, :3].astype(np.float32),
                tanfovx=float(np.tan(fov / 2)), tanfovy=float(np.tan(fov_y / 2)))


#: (name, options): SH degrees 0-4, the alive mask with precomputed covariances and
#: colours, Gaussians behind the camera, odd image sizes and tile sizes (12 is not a
#: power of two: the card divides by its float reciprocal)
PREPROCESS_CASES = {
    **{f"sh{d}": dict(sh_degree=d) for d in range(4)},
    "sh4": dict(sh_degree=4, num_coeffs=25),
    "sh2_k16_alive": dict(sh_degree=2, alive=0.7),
    "precomputed": dict(cov3d=True, colors=True, alive=0.7),
    "precomputed_cov": dict(cov3d=True, sh_degree=3),
    "behind_w77_t8": dict(behind=True, w=77, h=53, tile=8, sh_degree=1),
    "behind_w50_t12": dict(behind=True, w=50, h=37, tile=12, sh_degree=3),
    "dc_clamped": dict(sh_degree=3, dc=-1.5),
}


def preprocess_case(name, device, n=4000, seed=0, grad=False):
    """preprocess's arguments for one case of PREPROCESS_CASES on `device`, leaves that
    require grad when `grad`: a field of n Gaussians around and behind a rotated
    camera; many project past the +-1.3 tanfov clamp, and `dc` shifts the SH DC term
    so that many colours clamp at 0."""
    o = dict(sh_degree=0, num_coeffs=16, alive=None, cov3d=False, colors=False,
             behind=False, w=160, h=120, tile=16, dc=0.0)
    o.update(PREPROCESS_CASES[name])
    rng = np.random.default_rng(seed)
    z = rng.uniform(-3.0, 9.0, (n, 1)) if o["behind"] else rng.uniform(0.3, 9.0, (n, 1))
    means = np.concatenate([rng.uniform(-4, 4, (n, 2)), z], 1)
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.6), (n, 3)))
    quats = rng.normal(size=(n, 4))
    shs = 0.5 * rng.normal(size=(n, o["num_coeffs"], 3))
    shs[:, 0] += o["dc"]
    arrays = dict(means3d=means, scales=scales, quats=quats, shs=shs)
    if o["cov3d"]:
        rot = torch.tensor(quats / np.linalg.norm(quats, axis=1, keepdims=True))
        cov = transforms.build_covariance_3d(torch.tensor(scales), rot)
        arrays["cov3d_precomp"] = transforms.strip_symmetric(cov).numpy()
    if o["colors"]:
        arrays["colors_precomp"] = rng.uniform(size=(n, 3))
    tensors = {k: torch.tensor(v, dtype=torch.float32, device=device,
                               requires_grad=grad) for k, v in arrays.items()}
    cam = rotated_camera(o["w"], o["h"])
    kw = dict(tensors, **{k: torch.tensor(cam[k], device=device)
                          for k in ("viewmatrix", "projmatrix", "campos")})
    if o["alive"] is not None:
        kw["alive"] = torch.tensor(rng.uniform(size=n) < o["alive"], device=device)
    kw.update(image_height=o["h"], image_width=o["w"], tanfovx=cam["tanfovx"],
              tanfovy=cam["tanfovy"], sh_degree=o["sh_degree"], tile_size=o["tile"])
    return kw


def call_preprocess(fn, kw):
    kw = dict(kw)
    args = [kw.pop(k) for k in ("means3d", "scales", "quats", "shs", "viewmatrix",
                                "projmatrix", "campos")]
    return fn(*args, **kw)


def ulps(a, b):
    """Largest distance in float32 units in the last place between a and b (NaN in
    the same places, else a large number)."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        return 1 << 30

    def ordered(x):
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    keep = ~torch.isnan(a)
    if not bool(keep.any()):
        return 0
    return int((ordered(a[keep]) - ordered(b[keep])).abs().max())


PREP_FLOATS = ("means2d", "depths", "conics", "colors")
PREP_EXACT = ("radii", "tiles_min", "tiles_max", "visible")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PREPROCESS_CASES))
def test_preprocess_kernel_matches_plain(cuda_device, name):
    """The forward kernel against the plain version on the card: radii, tile rects and
    `visible` bit-equal, the float outputs within 4 ulp; one launch a call."""
    kw = preprocess_case(name, cuda_device)
    launches = _build.LAUNCHES["preprocess_fwd"]
    got = call_preprocess(projection.preprocess, kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["preprocess_fwd"] == launches + 1
    ref = call_preprocess(projection.preprocess_plain, kw)
    for field in PREP_EXACT:
        g, r = getattr(got, field), getattr(ref, field)
        assert g.dtype == r.dtype and g.shape == r.shape, field
        assert torch.equal(g, r), (field, int((g != r).sum()))
    for field in PREP_FLOATS:
        assert ulps(getattr(got, field), getattr(ref, field)) <= 4, field
    if "colors_precomp" in kw:
        assert got.colors is kw["colors_precomp"]
    assert 0 < int(got.visible.sum()) < got.visible.numel()


PREP_LEAVES = ("means3d", "scales", "quats", "shs", "cov3d_precomp", "colors_precomp")


def preprocess_grads(fn, kw, seed=1):
    """dL/d(each leaf that requires grad) of a random linear loss of every float
    output of `fn`, and the outputs."""
    out = call_preprocess(fn, kw)
    rng = np.random.default_rng(seed)
    weights = [torch.tensor(rng.normal(size=tuple(getattr(out, f).shape)),
                            dtype=torch.float32, device=out.means2d.device)
               for f in PREP_FLOATS]
    loss = sum((getattr(out, f) * w).sum() for f, w in zip(PREP_FLOATS, weights))
    leaves = [k for k in PREP_LEAVES if k in kw and kw[k].requires_grad]
    grads = torch.autograd.grad(loss, [kw[k] for k in leaves], allow_unused=True)
    return dict(zip(leaves, grads)), out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PREPROCESS_CASES))
def test_preprocess_backward_kernel_matches_autograd(cuda_device, name):
    """The backward kernel against torch.autograd of the plain version on the card:
    each leaf's gradient within 1e-5 of the norm of the leaf's reference gradient
    (clamped colours and clamped x/z included); one backward launch a call."""
    kw = preprocess_case(name, cuda_device, grad=True)
    ref, _ = preprocess_grads(projection.preprocess_plain, kw)
    launches = _build.LAUNCHES["preprocess_bwd"]
    got, out = preprocess_grads(projection.preprocess, kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["preprocess_bwd"] == launches + 1
    clamped = (out.colors == 0).float().mean()
    if name == "dc_clamped":
        assert 0.1 < float(clamped) < 0.9
    for k, r in ref.items():
        if r is None:        # an input the outputs do not depend on
            assert got[k] is None, k
            continue
        assert got[k] is not None and got[k].shape == r.shape, k
        norm = float(r.norm())
        assert norm > 0 and bool(torch.isfinite(got[k]).all()), k
        err = float((got[k] - r).abs().max())
        assert err <= 1e-5 * norm, (k, err, norm)


@pytest.mark.cuda
def test_preprocess_kernels_are_deterministic(cuda_device):
    kw = preprocess_case("sh3", cuda_device, grad=True)
    first, out = preprocess_grads(projection.preprocess, kw)
    second, out2 = preprocess_grads(projection.preprocess, kw)
    for field in PREP_FLOATS + PREP_EXACT:
        assert torch.equal(getattr(out, field), getattr(out2, field)), field
    for k in first:
        assert torch.equal(first[k], second[k]), k


@pytest.mark.cuda
def test_preprocess_kernel_refuses_what_it_does_not_take(cuda_device):
    """The launch wrapper refuses a non-contiguous input; `preprocess` copies one first
    (a data-parallel step's leaves are column views of one flat buffer) and gives the
    contiguous call's outputs, bit for bit. Both refuse float64 inputs, a camera that
    requires grad and too few SH coefficients."""
    kw = preprocess_case("sh3", cuda_device)
    rows = torch.cat([kw["means3d"], kw["scales"]], dim=1)
    strided = dict(kw, means3d=rows[:, :3], scales=rows[:, 3:])
    assert not strided["means3d"].is_contiguous()
    options = {k: kw[k] for k in ("image_height", "image_width", "tanfovx", "tanfovy",
                                  "sh_degree", "tile_size")}
    with pytest.raises(ValueError, match="contiguous"):
        projection.preprocess_forward_cuda(
            *(strided[k] for k in ("means3d", "scales", "quats", "shs")), None,
            *(kw[k] for k in ("viewmatrix", "projmatrix", "campos")), None,
            dict(options, scale_modifier=1.0))
    got = call_preprocess(projection.preprocess, strided)
    ref = call_preprocess(projection.preprocess, kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError, match="dtype"):
        call_preprocess(projection.preprocess, dict(kw, scales=kw["scales"].double()))
    grad_cam = dict(kw, campos=kw["campos"].clone().requires_grad_(True))
    with pytest.raises(ValueError, match="requires grad"):
        call_preprocess(projection.preprocess, grad_cam)
    with pytest.raises(ValueError, match="coefficients"):
        call_preprocess(projection.preprocess, dict(kw, sh_degree=4))


# ---------------------------------------------------------------------------
# SSIM: the kernels of csrc/ssim.cu against the plain version
# ---------------------------------------------------------------------------

#: the training views' sizes, odd sizes off the 32-pixel tile, a plane narrower and
#: shorter than the 11-tap window, a batch, and a row band multiplied by its row mask as
#: `parallel/dp_spatial.py band_loss` sends it (rows past the image zero in both)
SSIM_CASES = {"960x720": (3, 720, 960), "1024x768": (3, 768, 1024),
              "odd_77x101": (3, 77, 101), "narrow_7x5": (3, 7, 5),
              "batched": (2, 3, 45, 70), "band": (3, 96, 160)}


def ssim_pair(name, device, seed=0):
    shape = SSIM_CASES[name]
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape)
    b = np.clip(a + 0.1 * rng.normal(size=shape), 0, 1)
    img1, img2 = (torch.tensor(v, dtype=torch.float32, device=device) for v in (a, b))
    if name == "band":
        row_ok = (torch.arange(shape[1], device=device) < 70).float()[:, None]
        img1, img2 = img1 * row_ok, img2 * row_ok
    return img1, img2


def ssim_and_grad(fn, img1, img2):
    x = img1.clone().requires_grad_(True)
    value = fn(x, img2)
    (grad,) = torch.autograd.grad(value, [x])
    return value.detach(), grad


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SSIM_CASES))
def test_ssim_kernels_match_plain(cuda_device, name):
    """The kernels against the plain version on the same CUDA tensors: the SSIM map
    bit-equal, the mean within 1e-6 relative (summation order), img1's gradient within
    1e-5 of its largest magnitude (accumulation order); one launch of each a call."""
    from langsplat_tpu_torch.core import losses
    img1, img2 = ssim_pair(name, cuda_device)
    got_map = losses.ssim_map_cuda(img1, img2)
    want_map = losses.ssim_map_plain(img1, img2)
    assert torch.equal(got_map, want_map), int((got_map != want_map).sum())
    launches = dict(_build.LAUNCHES)
    got, got_grad = ssim_and_grad(losses.ssim, img1, img2)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssim_fwd"] == launches["ssim_fwd"] + 1
    assert _build.LAUNCHES["ssim_bwd"] == launches["ssim_bwd"] + 1
    want, want_grad = ssim_and_grad(losses.ssim_plain, img1, img2)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    scale = float(want_grad.abs().max())
    assert scale > 0 and bool(torch.isfinite(got_grad).all())
    assert float((got_grad - want_grad).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_ssim_kernels_are_deterministic(cuda_device):
    from langsplat_tpu_torch.core import losses
    img1, img2 = ssim_pair("1024x768", cuda_device)
    first = ssim_and_grad(losses.ssim, img1, img2)
    second = ssim_and_grad(losses.ssim, img1, img2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_ssim_kernels_refuse_what_they_do_not_take(cuda_device):
    """float64, a CPU/CUDA mix either way, img2 requiring grad and an even window
    raise; under no_grad nothing is saved and no backward launches; a non-contiguous
    image is read through a contiguous copy, bit for bit."""
    from langsplat_tpu_torch.core import losses
    img1, img2 = ssim_pair("odd_77x101", cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        losses.ssim(img1.double(), img2.double())
    with pytest.raises(ValueError, match="CUDA device"):
        losses.ssim(img1.cpu(), img2)
    with pytest.raises(ValueError, match="CUDA device"):
        losses.ssim(img1, img2.cpu())
    with pytest.raises(ValueError, match="img2 requires grad"):
        losses.ssim(img1, img2.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="odd window"):
        losses.ssim(img1, img2, window_size=10)
    launches = dict(_build.LAUNCHES)
    with torch.no_grad():
        value = losses.ssim(img1.clone().requires_grad_(True), img2)
    assert value.grad_fn is None
    assert _build.LAUNCHES["ssim_fwd"] == launches["ssim_fwd"] + 1
    wide = torch.cat([img1, img1], dim=-1)[..., 3:3 + img1.shape[-1]]
    assert not wide.is_contiguous()
    assert torch.equal(losses.ssim(wide, img2), losses.ssim(wide.contiguous(), img2))


@pytest.mark.cuda
def test_ssim_kernels_on_images_off_16_byte_alignment(cuda_device):
    """Contiguous images one float past an aligned address (views into a larger buffer)
    take the kernels' one-value-at-a-time loads and stores: the same mean and gradient,
    bit for bit, as aligned copies, at a width whose rows are 16-byte multiples."""
    from langsplat_tpu_torch.core import losses
    img1, img2 = ssim_pair("band", cuda_device)
    shifted = []
    for img in (img1, img2):
        buf = torch.zeros(img.numel() + 1, device=cuda_device)
        buf[1:] = img.reshape(-1)
        shifted.append(buf[1:].view(img.shape))
    assert shifted[0].data_ptr() % 16 != 0 and shifted[0].is_contiguous()
    got = ssim_and_grad(losses.ssim, *shifted)
    want = ssim_and_grad(losses.ssim, img1, img2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rgb", "feature"])
def test_ssim_kernels_run_once_a_phase_a_step(cuda_device, case):
    """`launches.ssim_fwd` and `launches.ssim_bwd` move by one each in a phase-A
    train_step_rgb, and not at all in a phase-B train_step_feature."""
    call = sync_case(case, cuda_device)
    call()                            # builds the kernels; first-use work
    launches = dict(_build.LAUNCHES)
    call()
    torch.cuda.synchronize()
    moved = {k: _build.LAUNCHES[k] - launches[k] for k in ("ssim_fwd", "ssim_bwd")}
    want = 1 if case == "rgb" else 0
    assert moved == {"ssim_fwd": want, "ssim_bwd": want}


# ---------------------------------------------------------------------------
# The overflow paths, each in a child process
# ---------------------------------------------------------------------------

REPO = Path(__file__).resolve().parent.parent
OVERFLOW_W, OVERFLOW_H = 256, 192   # 16 x 12 tiles: the grid (192) is past MAX_CULL_TMAX
OVERFLOW_BG = [0.2, 0.5, 0.9]
GUARD_CASES = ("fwd_f0", "fwd_f3", "fwd_empty", "bwd_full", "bwd_feature", "segsum")
TRUNCATED_CASES = ((0, "full"), (3, "full"), (3, "feature"))


def run_child(name: str, out: Path, timeout: int = 600) -> dict:
    """Run `name(device)` of this file in a new interpreter with CUDA_LAUNCH_BLOCKING=1
    and return the dict it saved."""
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING="1",
               PYTHONPATH=os.pathsep.join(filter(None, [str(REPO),
                                                        os.environ.get("PYTHONPATH")])))
    proc = subprocess.run([sys.executable, __file__, name, str(out)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return torch.load(out)


def overflow_params(n: int = 3000, seed: int = 21) -> dict:
    """field_params with sigmas of at most ~25 px at this camera (a rect of at most
    ~100 tiles) and opacities 0.1-0.3: past a rect's edge (3 sigma) alpha <= 0.3 e^-4.5
    < 1/255, so a rect edge that the card's rounding of the preprocess moves changes no
    pixel."""
    rng = np.random.default_rng(seed + 1)
    p = field_params(n, seed, 3)
    p["scaling"] = np.log(rng.uniform(0.02, 0.25, (n, 3))).astype(np.float32)
    opa = rng.uniform(0.1, 0.3, (n, 1))
    p["opacity"] = np.log(opa / (1 - opa)).astype(np.float32)
    return p


def overflow_camera(facing_away: bool = False):
    cam = camera(OVERFLOW_W, OVERFLOW_H)
    view, proj = cam["viewmatrix"], cam["projmatrix"]
    if facing_away:   # turned half a circle about its y axis: every Gaussian is behind
        flip = np.diag([-1.0, 1.0, -1.0, 1.0])
        view, proj = view @ flip, view @ flip @ np.linalg.solve(view, proj)
    return SimpleNamespace(world_view_transform=view.astype(np.float32),
                           full_proj_transform=proj.astype(np.float32),
                           camera_center=cam["campos"], tanfovx=cam["tanfovx"],
                           tanfovy=cam["tanfovy"], height=OVERFLOW_H, width=OVERFLOW_W)


def first_budget(field, cam, pipe, device) -> int:
    """An eighth of the instances the view bins at tile cap MAX_CULL_TMAX."""
    from langsplat_tpu_torch.ops.render import count_instances
    from langsplat_tpu_torch.train.loop import make_settings
    settings = make_settings(cam, pipe, 3, True, field.capacity,
                             max_tiles=tiles.MAX_CULL_TMAX)
    mats = [torch.as_tensor(m, device=device) for m in (
        cam.world_view_transform, cam.full_proj_transform, cam.camera_center)]
    with torch.no_grad():
        return count_instances(field, settings, *mats) // 8


def recorded_render_full(field, cam, pipe, device, **kw):
    """render_full with features, and each attempt's (budget, max_tiles, instances
    dropped, rect positions dropped), recorded by wrapping the loop's `render`."""
    from langsplat_tpu_torch.train import loop
    attempts = []
    inner = loop.render

    def render(field_, settings, *args, **kwargs):
        out = inner(field_, settings, *args, **kwargs)
        attempts.append([settings.budget, settings.max_tiles_per_gaussian,
                         int(out["instances_dropped"]), int(out["rect_dropped"])])
        return out

    loop.render = render
    try:
        out = loop.render_full(field, cam, pipe, 3, True, OVERFLOW_BG, device=device, **kw)
    finally:
        loop.render = inner
    keys = ("render", "language_feature_image", "final_transmittance")
    return {k: out[k].cpu() for k in keys}, attempts


def child_render_full_retries(device) -> dict:
    """render_full from an eighth of the budget and a tile cap of 2, and at an ample
    budget with the tile cap at the whole grid (unculled binning), on the card."""
    from langsplat_tpu_torch.config import PipelineConfig
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    field = from_numpy(overflow_params(), device)
    cam = overflow_camera()
    pipe = PipelineConfig()
    budget = first_budget(field, cam, pipe, device)
    launches = dict(_build.LAUNCHES)
    retried, attempts = recorded_render_full(field, cam, pipe, device, budget=budget,
                                             max_tiles=2)
    torch.cuda.synchronize()
    retry_launches = _build.LAUNCHES["blend_fwd"] - launches["blend_fwd"]
    grid = (OVERFLOW_W // 16) * (OVERFLOW_H // 16)
    ample, ample_attempts = recorded_render_full(field, cam, pipe, device,
                                                 budget=64 * field.capacity, max_tiles=grid)
    return dict(budget=budget, retried=retried, attempts=attempts, ample=ample,
                ample_attempts=ample_attempts, retry_launches=retry_launches)


def child_empty_view(device) -> dict:
    """render_full of a view that no Gaussian is in front of, on the card."""
    from langsplat_tpu_torch.config import PipelineConfig
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    field = from_numpy(overflow_params(), device)
    launches = dict(_build.LAUNCHES)
    out, attempts = recorded_render_full(field, overflow_camera(facing_away=True),
                                         PipelineConfig(), device)
    torch.cuda.synchronize()
    return dict(out=out, attempts=attempts,
                launches={k: _build.LAUNCHES[k] - launches[k] for k in launches})


def truncated(n, seed, w, h, num_feat, device, share=0.5):
    """`binned`, at an instance budget of `share` of what the view lists: the kept
    instances, and Gaussians whose offsets point past the budget."""
    prep, inst, opac, feats = binned(n, seed, w, h, num_feat, device)
    budget = int(share * int(inst.num_instances))
    inst = tiles.bin_gaussians(prep, grid_x=-(-w // 16), grid_y=-(-h // 16), budget=budget,
                               max_tiles_per_gaussian=64, tile_size=16, opacities=opac)
    assert int(inst.dropped) > 0 and int(inst.num_instances) == budget
    return prep, inst, opac, feats


def truncated_case(num_feat, grad_mode, device) -> dict:
    """K1, K2 and K3 on a truncated buffer against their plain versions."""
    from langsplat_tpu_torch.ops.segsum import segment_sum_cuda, segment_sum_plain
    w, h = 200, 129
    prep, inst, opac, feats = truncated(3000, 2, w, h, num_feat, device)
    bg = torch.tensor(OVERFLOW_BG, device=device)
    args = rasterize_cuda.blend_args(prep, inst, opac, feats, bg)
    size = dict(image_height=h, image_width=w, tile_size=16)
    image, t_final = rasterize_cuda.blend_forward_cuda(*args, **size)
    ref_image, ref_t = rasterize_cuda.blend_forward_plain(*args, **size)
    fwd_err = max(float((image - ref_image).abs().max()),
                  float((t_final - ref_t).abs().max()))
    g_image, g_tfinal, total = residuals(image, t_final, bg, 3)
    bwd_args = (*args[:8], inst.presort_slot, g_image, g_tfinal, total, t_final)
    bsize = dict(size, grad_mode=grad_mode)
    d_pre, t_replay = rasterize_cuda.blend_backward_cuda(*bwd_args, return_t=True, **bsize)
    ref = rasterize_cuda.blend_backward_plain(*bwd_args, **bsize)
    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-6)
    n = prep.means2d.shape[0]
    budget = inst.gauss_id.shape[0]
    ends = torch.clamp(inst.gauss_offsets, 0, budget).contiguous()
    sums = segment_sum_cuda(d_pre, ends, n).cpu()
    ref_sums = segment_sum_plain(d_pre.cpu(), ends.cpu(), n)
    offsets = inst.gauss_offsets.cpu()
    all_dropped = (offsets[1:] > offsets[:-1]) & (offsets[:-1] >= budget)
    return dict(fwd_err=fwd_err, t_replay_equal=bool(torch.equal(t_replay, t_final)),
                bwd_rel=float(((d_pre - ref).abs() / scale).max()),
                bwd_max=float(ref.abs().max()),
                seg_rel=float(((sums - ref_sums).abs()
                               / ref_sums.abs().amax(dim=1, keepdim=True)).max()),
                all_dropped=int(all_dropped.sum()),
                all_dropped_max=float(sums[:, all_dropped].abs().max()),
                finite=bool(torch.isfinite(image).all() and torch.isfinite(d_pre).all()))


def guard_case(case, device) -> dict:
    """Launch one kernel with each output a view inside 64 KiB of guard words on each
    side: the guard words changed, and whether the outputs equal a launch into tensors
    of their own, bit for bit."""
    from langsplat_tpu_torch.ops.segsum import segment_sum_cuda
    w, h = 77, 53
    num_feat = 0 if case == "fwd_f0" else 3
    prep, inst, opac, feats = truncated(500, 1, w, h, num_feat, device)
    if case == "fwd_empty":
        prep = prep._replace(visible=torch.zeros_like(prep.visible))
        inst = tiles.bin_gaussians(prep, grid_x=5, grid_y=4, budget=4096,
                                   max_tiles_per_gaussian=64, tile_size=16, opacities=opac)
        assert int(inst.num_instances) == 0
    bg = torch.tensor(OVERFLOW_BG, device=device)
    args = rasterize_cuda.blend_args(prep, inst, opac, feats, bg)
    size = dict(image_height=h, image_width=w, tile_size=16)
    image, t_final = rasterize_cuda.blend_forward_cuda(*args, **size)
    if case.startswith("fwd"):
        want = [image, t_final]
        outs = [_build.guarded(t.shape, torch.float32, device) for t in want]
        rasterize_cuda.blend_forward_cuda(*args, **size, out=[o for o, _ in outs])
    else:
        g_image, g_tfinal, total = residuals(image, t_final, bg, 4)
        bwd_args = (*args[:8], inst.presort_slot, g_image, g_tfinal, total, t_final)
        bsize = dict(size, grad_mode="feature" if case == "bwd_feature" else "full",
                     return_t=True)
        want = list(rasterize_cuda.blend_backward_cuda(*bwd_args, **bsize))
        if case.startswith("bwd"):
            outs = [_build.guarded(t.shape, torch.float32, device) for t in want]
            outs[0][0].fill_(float("nan"))     # the wrapper zeroes d_pre before the launch
            rasterize_cuda.blend_backward_cuda(*bwd_args, **bsize,
                                               out=[o for o, _ in outs])
        else:
            ends = torch.clamp(inst.gauss_offsets, 0, inst.gauss_id.shape[0]).contiguous()
            n = prep.means2d.shape[0]
            lengths = ends[1:] - ends[:-1]
            assert int((lengths == 0).sum()) > 0
            assert int(ends[-1]) < int(inst.gauss_offsets[-1])
            d_pre = want[0]
            want = [segment_sum_cuda(d_pre, ends, n)]
            outs = [_build.guarded(want[0].shape, torch.float32, device)]
            segment_sum_cuda(d_pre, ends, n, out=outs[0][0])
    torch.cuda.synchronize()
    return dict(changed=sum(changed() for _, changed in outs),
                equal=all(torch.equal(o, t) for (o, _), t in zip(outs, want)),
                numel=sum(t.numel() for t in want))


def child_overflow_kernels(device) -> dict:
    """The truncated-buffer and guard-word cases, each one's result or its traceback."""
    results = {}
    cases = [(f"truncated_{f}_{m}", lambda f=f, m=m: truncated_case(f, m, device))
             for f, m in TRUNCATED_CASES]
    cases += [(f"guard_{c}", lambda c=c: guard_case(c, device)) for c in GUARD_CASES]
    for name, fn in cases:
        try:
            results[name] = fn()
        except Exception:
            results[name] = dict(error=traceback.format_exc())
    return results


@pytest.fixture(scope="module")
def overflow_kernels(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return run_child("child_overflow_kernels",
                     tmp_path_factory.mktemp("overflow") / "kernels.pt")


@pytest.mark.cuda
@pytest.mark.parametrize("num_feat,grad_mode", TRUNCATED_CASES)
def test_kernels_on_a_truncated_buffer_match_plain(overflow_kernels, num_feat, grad_mode):
    """K1, K2 and K3 on an instance buffer cut to half of what the view lists (the
    Gaussians past the cut keep offsets past the budget) against their plain versions,
    at the limits above: 2e-4 absolute, 1e-4 and 1e-5 of each row's largest value; the
    Gaussians whose instances were all dropped sum to exactly zero."""
    r = overflow_kernels[f"truncated_{num_feat}_{grad_mode}"]
    assert "error" not in r, r.get("error")
    assert r["finite"] and r["t_replay_equal"]
    assert r["fwd_err"] <= CARD_ATOL
    assert r["bwd_max"] > 0 and r["bwd_rel"] < 1e-4
    assert r["seg_rel"] <= 1e-5
    assert r["all_dropped"] > 0 and r["all_dropped_max"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", GUARD_CASES)
def test_kernels_write_only_inside_their_outputs(overflow_kernels, case):
    """Each kernel launched with its outputs as views inside 64 KiB of guard words on
    each side (K1 with F = 0 and 3 on a 77x53 image, K1 where no Gaussian is visible, K2
    in both grad modes, K3 with clamped ends and empty segments, on truncated buffers):
    every guard word unchanged, and the outputs bit-equal to a launch into tensors of
    their own."""
    r = overflow_kernels[f"guard_{case}"]
    assert "error" not in r, r.get("error")
    assert r["numel"] > 0 and r["changed"] == 0 and r["equal"]


@pytest.mark.cuda
def test_render_full_retries_on_card(cuda_device, tmp_path):
    """render_full from an eighth of the budget and a tile cap of 2: the first pass
    drops instances and tile positions, both caps grow, and the last pass drops nothing
    at a culled tile cap. Its image is bit-equal to the render at an ample budget with
    the tile cap at the whole grid (unculled binning), and within 2e-4 of render_full
    on the CPU."""
    from langsplat_tpu_torch.config import PipelineConfig
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    r = run_child("child_render_full_retries", tmp_path / "retries.pt")
    att = r["attempts"]
    assert att[0][2] > 0 and att[0][3] > 0
    assert att[-1][0] > att[0][0] and att[-1][1] > att[0][1]
    assert att[-1][2:] == [0, 0] and att[-1][1] <= tiles.MAX_CULL_TMAX
    assert r["retry_launches"] == len(att)
    assert len(r["ample_attempts"]) == 1
    assert r["ample_attempts"][0][1] > tiles.MAX_CULL_TMAX
    for k, v in r["retried"].items():
        assert torch.equal(v, r["ample"][k]), k
    cpu, _ = recorded_render_full(from_numpy(overflow_params(), "cpu"), overflow_camera(),
                                  PipelineConfig(), "cpu", budget=r["budget"], max_tiles=2)
    for k, v in r["retried"].items():
        assert float((v - cpu[k]).abs().max()) <= CARD_ATOL, k
    assert float(r["retried"]["final_transmittance"].min()) < 0.5


@pytest.mark.cuda
def test_render_full_of_an_empty_view_on_card(cuda_device, tmp_path):
    """render_full with the camera facing away from the field: one pass, the forward
    kernel launched on an empty buffer, the background everywhere and T = 1."""
    r = run_child("child_empty_view", tmp_path / "empty.pt")
    assert len(r["attempts"]) == 1 and r["attempts"][0][2:] == [0, 0]
    assert r["launches"]["blend_fwd"] == 1
    out = r["out"]
    assert bool((out["final_transmittance"] == 1.0).all())
    assert bool((out["language_feature_image"] == 0.0).all())
    bg = torch.tensor(OVERFLOW_BG)[:, None, None].expand_as(out["render"])
    assert torch.equal(out["render"], bg)


# ---------------------------------------------------------------------------
# Binning: the kernels of csrc/binning.cu against the plain version on the card
# ---------------------------------------------------------------------------

INSTANCE_FIELDS = ("gauss_id", "tile_id", "tile_start", "num_instances", "dropped",
                   "rect_dropped", "presort_slot", "gauss_offsets")
BIN_LAUNCHES = ("bin_count", "bin_rank", "bin_emit", "bin_sort", "bin_ranges")


def cell_view(cell: str, device, seed: int = 3, view: int = 0):
    """View `view` of a benchmark cell's field at its size and the render's caps:
    (prep, opacities, binning arguments)."""
    from bench_port import harness, scenes
    from bench_port.drivers import program
    from langsplat_tpu_torch.train.loop import make_settings
    config = harness.load_cell(cell).config
    sc = scenes.make(config, seed, device)
    field = program.field_of(sc.leaves, False)
    cam = program.cameras(sc)[view]
    settings = make_settings(cam, program.pipeline(config), 3, False, field.capacity)
    with torch.no_grad():
        prep = projection.preprocess(
            field.xyz, field.get_scaling, field.rotation, field.get_features,
            *program.matrices(cam, device), image_height=cam.height,
            image_width=cam.width, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
            sh_degree=3, tile_size=settings.tile_size, alive=field.alive)
        opac = field.get_opacity[:, 0]
    return prep, opac, dict(grid_x=settings.grid_x, grid_y=settings.grid_y,
                            budget=settings.budget, tile_size=settings.tile_size,
                            max_tiles_per_gaussian=settings.max_tiles_per_gaussian)


def small_view(n, seed, w, h, device, scale=1.0):
    """`binned`'s scene and camera, before binning: (prep, opacities, arguments)."""
    s = {k: torch.tensor(v, device=device) for k, v in scene(n, seed, 0).items()}
    cam = camera(w, h)
    prep = projection.preprocess(
        s["means"], s["scales"] * scale, s["quats"], None,
        *(torch.tensor(cam[k], device=device) for k in ("viewmatrix", "projmatrix",
                                                        "campos")),
        image_height=h, image_width=w, tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
        sh_degree=0, tile_size=16, colors_precomp=s["colors"])
    return prep, s["opac"], dict(grid_x=-(-w // 16), grid_y=-(-h // 16), budget=64 * n,
                                 tile_size=16, max_tiles_per_gaussian=32)


def bin_case(name: str, device):
    """(prep, opacities, arguments, what the case must show) of a binning case."""
    if name in ("lerf_1m", "synthroom_15k"):
        cell = "render.lerf-1m" if name == "lerf_1m" else "train-a.synthroom-15k"
        return (*cell_view(cell, device), "culled")
    prep, opac, kw = small_view(3001, 5, 200, 129, device)    # 3001: no block multiple
    if name == "odd_n":
        return prep, opac, kw, "culled"
    if name == "budget_overflow":
        total = int(tiles.instance_counts_plain(prep, tile_size=16, tmax=32,
                                                opacities=opac).sum())
        return prep, opac, dict(kw, budget=total // 3), "dropped"
    if name == "tmax_overflow":       # rects past the cap: their tail in rect_dropped
        return prep, opac, dict(kw, max_tiles_per_gaussian=2), "rect_dropped"
    if name == "unculled":
        prep, opac, kw = small_view(3001, 6, 200, 129, device, scale=3.0)
        return prep, opac, dict(kw, max_tiles_per_gaussian=tiles.MAX_CULL_TMAX + 32), \
            "unculled"
    if name == "unculled_no_tile_size":
        return prep, opac, dict(kw, tile_size=None, max_tiles_per_gaussian=16), "unculled"
    if name == "opacity_below_eps":   # below ALPHA_EPS: culled whole, tail not dropped
        opac = opac.clone()
        opac[::3] = 1e-3
        return prep, opac, dict(kw, max_tiles_per_gaussian=4), "faint"
    if name == "no_opacity":
        return prep, None, kw, "culled"
    if name == "empty_view":
        return prep._replace(visible=torch.zeros_like(prep.visible)), opac, kw, "empty"
    if name == "key64":               # 12 rank bits + 22 tile bits: 64-bit keys
        return prep, opac, dict(kw, grid_x=4096, grid_y=1024), "key64"
    raise KeyError(name)


BIN_CASES = ("lerf_1m", "synthroom_15k", "odd_n", "budget_overflow", "tmax_overflow",
             "unculled", "unculled_no_tile_size", "opacity_below_eps", "no_opacity",
             "empty_view", "key64")


@pytest.mark.cuda
@pytest.mark.parametrize("case", BIN_CASES)
def test_binning_kernels_match_plain(cuda_device, case):
    """Every InstanceBuffer field of the kernels bit-equal to the plain version on the
    card, and the count kernel's instance counts equal to the plain ones: a lerf-1m view
    and the synthroom field at capacity 168,000 at the render's caps, 3,001 Gaussians
    (no multiple of a block) with the budget below the total, rects past the tile cap,
    the unculled path (a cap past MAX_CULL_TMAX, and no tile size), opacities below
    ALPHA_EPS, no opacities, no visible Gaussian, and 64-bit sort keys."""
    prep, opac, kw, expect = bin_case(case, cuda_device)
    want = tiles.bin_gaussians_plain(prep, opacities=opac, **kw)
    got = tiles.bin_gaussians_cuda(prep, opacities=opac, **kw)
    torch.cuda.synchronize()
    for name in INSTANCE_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.int32 and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert got.max_tiles == want.max_tiles
    count_kw = dict(tile_size=kw["tile_size"], tmax=kw["max_tiles_per_gaussian"],
                    opacities=opac)
    counts = tiles.instance_counts_cuda(prep, **count_kw)
    assert torch.equal(counts, tiles.instance_counts_plain(prep, **count_kw))
    num, dropped = int(got.num_instances), int(got.dropped)
    rect_dropped = int(got.rect_dropped)
    print(f"{case}: {prep.means2d.shape[0]} Gaussians, {num} instances, {dropped} "
          f"dropped, {rect_dropped} rect positions dropped")
    if expect == "culled":
        assert num > 0 and dropped == 0
    elif expect == "dropped":
        assert dropped > 0 and num == kw["budget"]
    elif expect == "rect_dropped":
        assert rect_dropped > 0 and dropped == 0
    elif expect == "unculled":
        assert num > 0 and (kw["tile_size"] is None
                            or kw["max_tiles_per_gaussian"] > tiles.MAX_CULL_TMAX)
    elif expect == "faint":
        faint = prep.visible & (opac < 1.0 / 255.0)
        assert bool(faint.any()) and int(counts[faint].sum()) == 0 and rect_dropped > 0
    elif expect == "empty":
        assert num == 0 and int(got.tile_start.abs().sum()) == 0
    elif expect == "key64":
        assert (prep.means2d.shape[0] - 1).bit_length() + (kw["grid_x"] * kw["grid_y"]
                                                           - 1).bit_length() > 32
        assert num > 0


@pytest.mark.cuda
def test_binning_makes_no_sync_and_launches_each_kernel_once(cuda_device):
    """One bin_gaussians call on CUDA tensors under
    torch.cuda.set_sync_debug_mode("error"): no synchronizing operation, and each
    `launches.bin_*` counter moves by one."""
    prep, opac, kw = small_view(3001, 5, 200, 129, cuda_device)
    tiles.bin_gaussians(prep, opacities=opac, **kw)      # builds the library
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        inst = tiles.bin_gaussians(prep, opacities=opac, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    moved = {k: _build.LAUNCHES[k] - launches[k] for k in launches}
    assert {k: moved[k] for k in BIN_LAUNCHES} == dict.fromkeys(BIN_LAUNCHES, 1)
    assert sum(moved.values()) == len(BIN_LAUNCHES)
    assert int(inst.num_instances) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["odd_n", "budget_overflow", "key64", "empty_view"])
def test_binning_writes_only_inside_its_outputs(cuda_device, case):
    """The kernels with every InstanceBuffer output a view inside 64 KiB of guard words
    on each side: every guard word unchanged, the outputs bit-equal to a call into
    tensors of their own."""
    prep, opac, kw, _ = bin_case(case, cuda_device)
    want = tiles.bin_gaussians_cuda(prep, opacities=opac, **kw)
    outs = {name: _build.guarded(getattr(want, name).shape, torch.int32, cuda_device)
            for name in INSTANCE_FIELDS}
    got = tiles.bin_gaussians_cuda(
        prep, opacities=opac, **kw, out=tiles.InstanceBuffer(
            **{name: view for name, (view, _) in outs.items()}, max_tiles=want.max_tiles))
    torch.cuda.synchronize()
    assert sum(changed() for _, changed in outs.values()) == 0
    for name in INSTANCE_FIELDS:
        assert getattr(got, name).data_ptr() == outs[name][0].data_ptr(), name
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def sync_warnings(fn) -> int:
    """fn() under torch.cuda.set_sync_debug_mode("warn"): the syncs it was warned of."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


def sync_case(case, device):
    """The call of `case` on the card: a phase-A step (the culled binning, and past a
    tile cap of 128 the unculled one), a phase-B step, render_full from the policy's caps
    and from an eighth of the budget and a tile cap of 2 (retries)."""
    from langsplat_tpu_torch.config import OptimizationConfig, PipelineConfig
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    from langsplat_tpu_torch.train import trainer
    from langsplat_tpu_torch.train.densify import DensifyStats
    from langsplat_tpu_torch.train.loop import render_full
    if case.startswith("render_full"):
        field = from_numpy(overflow_params(), device)
        cam, pipe = overflow_camera(), PipelineConfig()
        start = {}
        if case == "render_full_retries":
            start = dict(budget=first_budget(field, cam, pipe, device), max_tiles=2)
        return lambda: render_full(field, cam, pipe, 3, True, OVERFLOW_BG, device=device,
                                   **start)
    feature = case == "feature"
    n, w, h = 2000, 160, 120
    field = from_numpy(field_params(n, 6, 3 if feature else 0), device)
    cam = camera(w, h)
    settings = RenderSettings(
        image_height=h, image_width=w, tanfovx=cam["tanfovx"], tanfovy=cam["tanfovy"],
        sh_degree=3, budget=64 * n, include_feature=feature,
        max_tiles_per_gaussian=256 if case == "rgb_unculled" else 32,
        grad_mode="feature" if feature else "full")
    optimizer = trainer.make_optimizer(OptimizationConfig(), 1.0, feature)
    state = optimizer.init(trainer.extract_params(field, feature))
    stats = DensifyStats.zeros(n, device)
    mats = [torch.tensor(cam[k], device=device) for k in ("viewmatrix", "projmatrix",
                                                          "campos")]
    rng = np.random.default_rng(7)
    gt = torch.tensor(rng.uniform(size=(3, h, w)).astype(np.float32), device=device)
    bg = torch.zeros(3, device=device)
    if feature:
        mask = torch.tensor((rng.uniform(size=(1, h, w)) < 0.8).astype(np.float32),
                            device=device)
        return lambda: trainer.train_step_feature(field, state, stats, *mats, gt, mask, bg,
                                                  settings=settings, optimizer=optimizer)
    return lambda: trainer.train_step_rgb(field, state, stats, *mats, gt, bg,
                                          settings=settings, optimizer=optimizer,
                                          lambda_dssim=0.2)


#: the syncs of each training-step case on the card: binning makes none there, so
#: phase A keeps its statistics' one and phase B none (the tracer counts binning's 5-6
#: on the CPU, where the plain version runs: tests/test_torch_tracing.py); None:
#: render_full, whose tries vary
SYNC_CASES = {"rgb": 1, "rgb_unculled": 1, "feature": 0, "render_full": None,
              "render_full_retries": None}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_every_sync_on_the_card_is_counted(cuda_device, case):
    """Every synchronizing operation that torch.cuda.set_sync_debug_mode("warn") sees
    in one training step or one render_full is one increment of the tracer's
    `host_syncs` (utils/tracing.py): none goes uncounted, none is counted twice."""
    from langsplat_tpu_torch.utils.tracing import COUNTERS
    call = sync_case(case, cuda_device)
    call()                            # builds the kernels; first-use work
    attempts = COUNTERS["render_attempts"]
    before = COUNTERS["host_syncs"]
    warned = sync_warnings(call)
    counted = COUNTERS["host_syncs"] - before
    tries = COUNTERS["render_attempts"] - attempts
    print(f"{case}: {warned} syncs warned of, {counted} counted, {tries} tries")
    assert warned == counted
    if SYNC_CASES[case] is not None:
        assert counted == SYNC_CASES[case]
    else:   # 4 copies of the camera, then the 2 drop reads a try
        assert tries >= (2 if case == "render_full_retries" else 1)
        assert counted == 4 + 2 * tries


def tiny_sam(device, sharp: bool):
    """The port's SAM at a small size that keeps every kind of block (an 8x8 grid,
    windows of 3, global blocks 1 and 3), seeded weights; `sharp` biases the IoU head up
    and scales the mask logits so that masks pass the generator's filters."""
    from langsplat_tpu_torch.models import sam
    cfg = sam.SamConfig(image_size=128, patch_size=16, encoder_width=64, encoder_depth=4,
                        encoder_heads=4, encoder_mlp_dim=256, window_size=3,
                        global_attn_indexes=(1, 3), prompt_width=32, decoder_heads=4,
                        decoder_mlp_dim=64, iou_head_hidden_dim=32)
    # drawn on the CPU: a card's generator draws other numbers from the same seed
    model = sam.build_sam(cfg, seed=2**31 + 101).to(device)
    if sharp:
        with torch.no_grad():
            model.mask_decoder.iou_prediction_head.layers[-1].bias.fill_(2.0)
            for mlp in model.mask_decoder.output_hypernetworks_mlps:
                mlp.layers[-1].weight.mul_(200.0)
    return model


def sam_view(seed=5, h=96, w=128) -> np.ndarray:
    low = torch.rand((1, 3, h // 16, w // 16), generator=torch.Generator().manual_seed(seed))
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear")
    return (img[0].permute(1, 2, 0) * 255).round().to(torch.uint8).numpy()


@pytest.mark.cuda
def test_sam_on_the_card_matches_the_cpu_in_float32(cuda_device):
    """The embedding, low-res logits and IoU predictions of one crop on the card and on
    the CPU agree to float32 rounding (2e-5 of the largest magnitude): the products run
    without TF32, which would move them by ~1e-3."""
    from langsplat_tpu_torch.preprocess.backends import SamPredictor
    image, points = sam_view(), np.array([[10.5, 20.25], [100.0, 70.0], [127.0, 95.0]])
    outs = []
    for dev in (torch.device("cpu"), cuda_device):
        pred = SamPredictor(tiny_sam(dev, sharp=False), device=dev)
        pred.set_image(image)
        low, iou = pred.decode(points)
        outs.append([t.cpu() for t in (pred.embedding, low, iou)])
    for a, b in zip(*outs):
        assert float((a - b).abs().max() / b.abs().max()) < 2e-5


@pytest.mark.cuda
def test_every_sync_of_the_mask_generator_is_counted(cuda_device):
    """Every synchronizing operation that torch.cuda.set_sync_debug_mode("warn") sees
    in one `AutoMaskGenerator.generate` through `SamPredictor` is one increment of
    `host_syncs`: 2 a crop (the crop's and the normalisation's uploads), 2 a batch (the
    points' upload, the filters' nonzero) and 3 more a batch that keeps masks."""
    from langsplat_tpu_torch.preprocess.auto_mask import AutoMaskConfig, AutoMaskGenerator
    from langsplat_tpu_torch.preprocess.backends import SamPredictor
    from langsplat_tpu_torch.utils.tracing import COUNTERS
    gen = AutoMaskGenerator(SamPredictor(tiny_sam(cuda_device, sharp=True), cuda_device),
                            AutoMaskConfig(points_per_side=4, points_per_batch=8,
                                           crop_n_layers=1), device=cuda_device)
    image = sam_view()
    gen.generate(image)
    before = dict(COUNTERS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            gen.generate(image)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    moved = {k: COUNTERS[k] - before[k] for k in COUNTERS}
    print(f"sam: {len(sites)} syncs warned of, {moved['host_syncs']} counted, "
          f"{moved['sam.masks_kept']} masks kept; sites {sorted(set(sites))}")
    assert moved["sam.encoder_passes"] == 5 and moved["sam.decoder_batches"] == 10
    assert moved["sam.masks_kept"] > 0
    assert len(sites) == moved["host_syncs"] >= 5 * 2 + 10 * 2, sites


@pytest.mark.cuda
def test_every_sync_of_embed_masks_is_counted(cuda_device):
    """Every synchronizing operation that torch.cuda.set_sync_debug_mode("warn") sees
    in one `embed_masks` of the benchmark's seeded masks at its tiny size
    (`bench_port/tests/tiny_clip.json`) through `ClipImageEncoder` is one increment of
    `host_syncs`: the image's upload, 5 a level in the mask NMS (the order's upload,
    three fallback reads, the keep read) and 2 a level in the tiles (the boxes' and the
    unit table's uploads)."""
    import json
    from bench_port.drivers.embed import clip_config, view_masks
    from bench_port.drivers.preprocess import views_of
    from langsplat_tpu_torch.models.clip import build_clip
    from langsplat_tpu_torch.preprocess.backends import ClipImageEncoder
    from langsplat_tpu_torch.preprocess.pipeline import embed_masks
    from langsplat_tpu_torch.utils.tracing import COUNTERS
    cfg = json.loads((Path(__file__).resolve().parent.parent / "bench_port" / "tests"
                      / "tiny_clip.json").read_text())
    seed = 2**31 + 313
    levels = view_masks(cfg, seed, 0, cuda_device)
    image = views_of(cfg, seed, cuda_device)[0]
    encoder = ClipImageEncoder(build_clip(clip_config(cfg), seed=seed, device=cuda_device),
                               cuda_device, cfg["batch_size"])
    embed_masks(image, levels, encoder)
    before = dict(COUNTERS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            embeds, _ = embed_masks(image, levels, encoder)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = [f"{Path(w.filename).name}:{w.lineno}" for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    moved = {k: COUNTERS[k] - before[k] for k in COUNTERS}
    print(f"embed_masks: {len(sites)} syncs warned of, {moved['host_syncs']} counted, "
          f"{moved['clip.tiles']} tiles; sites {sorted(set(sites))}")
    assert len(embeds) == 4 and moved["clip.tiles"] == sum(len(e) for e in embeds.values())
    assert len(sites) == moved["host_syncs"] == 1 + 4 * 5 + 4 * 2, sites


# ---------------------------------------------------------------------------
# Adam: the kernel of csrc/adam.cu against the plain per-group version
# ---------------------------------------------------------------------------

#: rgb_<cap>: phase A's six groups (1,003: float4s and a scalar tail); feature: phase
#: B's one group; zeroed: moments partly zeroed by `zero_moment_rows`; cat_grads: the
#: f_dc and f_rest gradients as autograd hands them out, slices of one [cap, 16, 3]
#: tensor; shard: rank 1 of 3 of a ZeRO-2 layout (params and gradients as the strided
#: column views of `data_parallel.unflat_rows`, rows off 16-byte alignment);
#: xyz_count_<c>: every count, and the schedule's, at c
ADAM_CASES = ("rgb_200", "rgb_1003", "feature", "feature_colmajor", "zeroed",
              "cat_grads", "shard", "xyz_count_0", "xyz_count_1", "xyz_count_7",
              "xyz_count_29999")
ADAM_WIDTHS = {"xyz": (3,), "f_dc": (1, 3), "f_rest": (15, 3), "scaling": (3,),
               "rotation": (4,), "opacity": (1,), "language_feature": (3,)}


def adam_case(name: str, device, seed: int = 0):
    """(optimizer, grads, state, params) of one of ADAM_CASES, drawn from `seed`."""
    from langsplat_tpu_torch.config import OptimizationConfig
    from langsplat_tpu_torch.parallel.data_parallel import flat_rows, unflat_rows
    from langsplat_tpu_torch.train import trainer
    rng = np.random.default_rng(seed)
    feature = name.startswith("feature")
    cap = {"rgb_1003": 1003, "shard": 1002}.get(name, 200)
    optimizer = trainer.make_optimizer(OptimizationConfig(), 2.5, feature)

    def draw(scale, label, positive=False):
        x = scale * rng.normal(size=(cap, *ADAM_WIDTHS[label]))
        return torch.tensor((np.abs(x) if positive else x).astype(np.float32),
                            device=device)

    count = int(name.rsplit("_", 1)[1]) if name.startswith("xyz_count") else 3
    params = {k: draw(1.0, k) for k in optimizer.labels}
    grads = {k: draw(10.0 ** rng.integers(-6, 0), k) for k in optimizer.labels}
    state = optimizer.init(params)
    for k, s in state.items():
        s.update(mu=draw(1e-3, k), nu=draw(1e-6, k, positive=True))
        for c in ("count", "sched_count"):
            if c in s:
                s[c] = torch.tensor(count, dtype=torch.int32, device=device)
    if name == "zeroed":
        mask = torch.tensor(rng.uniform(size=cap) < 0.3, device=device)
        state = trainer.zero_moment_rows(state, mask)
        state = trainer.zero_moment_rows(state, torch.ones(cap, dtype=torch.bool,
                                                           device=device),
                                         only_label="opacity")
    if name == "feature_colmajor":   # as autograd hands out phase B's on the card
        grads["language_feature"] = grads["language_feature"].t().contiguous().t()
    if name == "cat_grads":
        features = torch.cat([grads["f_dc"], grads["f_rest"]], dim=1)
        grads.update(f_dc=features[:, :1], f_rest=features[:, 1:])
    if name == "shard":
        lo, hi = cap // 3, 2 * cap // 3
        params = unflat_rows(flat_rows(params)[lo:hi], params)
        grads = unflat_rows(flat_rows(grads)[lo:hi], grads)
        state = {label: {k: v[lo:hi].clone() if v.dim() else v for k, v in s.items()}
                 for label, s in state.items()}
    return optimizer, grads, state, params


def adam_outputs(state, params, device):
    """Guarded outputs {label: {"param", "mu", "nu", "count"[, "sched_count"]}} for
    `adam_update_cuda`, and the functions that count their changed guard words."""
    outs, changed = {}, []
    for label, s in state.items():
        outs[label] = {}
        for k in ("param", "mu", "nu", "count", "sched_count"):
            if k == "param" or k in s:
                like = params[label] if k == "param" else s[k]
                view, fn = _build.guarded(like.shape, like.dtype, device)
                outs[label][k] = view
                changed.append(fn)
    return outs, changed


def adam_leaves(params, state) -> list:
    return [t.clone() for t in (*params.values(),
                                *(v for s in state.values() for v in s.values()))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ADAM_CASES)
def test_adam_kernel_matches_plain(cuda_device, case):
    """New params, mu, nu, count and sched_count bit-equal to `Adam.update_plain` on
    the card, through `Adam.update` and through the kernel's wrapper into guarded
    outputs: one launch a call, no host sync, no write outside the outputs, the
    inputs left as they were."""
    from langsplat_tpu_torch.train import trainer
    optimizer, grads, state, params = adam_case(case, cuda_device)
    inputs = adam_leaves(params, state) + [g.clone() for g in grads.values()]
    want_p, want_s = optimizer.update_plain(grads, state, params)
    outs, changed = adam_outputs(state, params, cuda_device)
    for call in ("update", "wrapper"):
        launches = _build.LAUNCHES["adam_update"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            if call == "update":
                got_p, got_s = optimizer.update(grads, state, params)
            else:
                rates = {k: f(state[k]["sched_count"])
                         for k, f in optimizer.schedules.items()}
                got_p, got_s = trainer.adam_update_cuda(grads, state, params,
                                                        optimizer.lrs, rates, out=outs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["adam_update"] == launches + 1, call
        assert got_p.keys() == want_p.keys() and got_s.keys() == want_s.keys()
        for k in want_p:
            assert torch.equal(got_p[k], want_p[k]), (call, k)
            assert list(got_s[k]) == list(want_s[k]), (call, k)
            for leaf in want_s[k]:
                assert got_s[k][leaf].dtype == want_s[k][leaf].dtype
                assert torch.equal(got_s[k][leaf], want_s[k][leaf]), (call, k, leaf)
    assert sum(fn() for fn in changed) == 0
    for label in outs:
        assert got_p[label].data_ptr() == outs[label]["param"].data_ptr()
    after = adam_leaves(params, state) + list(grads.values())
    assert all(torch.equal(a, b) for a, b in zip(inputs, after))


@pytest.mark.cuda
def test_adam_kernel_bias_corrections_at_every_count(cuda_device):
    """The kernel's bias corrections, 1 - b^(count + 1) in float32, bit-equal to the
    plain version's at every count of a 30,000-step run: groups of one element, eight
    counts a launch, against the plain version's arithmetic over all counts at once."""
    from langsplat_tpu_torch.train import trainer
    steps, f32 = 30_000, torch.float32
    labels = [f"g{i}" for i in range(trainer.ADAM_MAX_GROUPS)]
    lrs = dict.fromkeys(labels, 1.0)
    one = {k: torch.full((1,), v, dtype=f32, device=cuda_device)
           for k, v in (("p", 0.0), ("g", 0.3), ("mu", 0.2), ("nu", 0.05))}
    got = []
    for start in range(0, steps, len(labels)):
        state = {k: dict(count=torch.tensor(start + i, dtype=torch.int32,
                                            device=cuda_device), mu=one["mu"], nu=one["nu"])
                 for i, k in enumerate(labels)}
        new_p, _ = trainer.adam_update_cuda(dict.fromkeys(labels, one["g"]), state,
                                            dict.fromkeys(labels, one["p"]), lrs, {})
        got += [new_p[k] for k in labels]
    got = torch.cat(got)
    g, mu, nu = (one[k].expand(steps) for k in ("g", "mu", "nu"))
    mu = g * (1 - trainer.B1) + mu * trainer.B1
    nu = g * g * (1 - trainer.B2) + nu * trainer.B2
    c = (torch.arange(steps, dtype=torch.int32, device=cuda_device) + 1).to(f32)
    direction = (mu / (1 - torch.pow(trainer.B1, c))) / (
        torch.sqrt(nu / (1 - torch.pow(trainer.B2, c))) + trainer.EPS)
    want = one["p"] + -1.0 * direction
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rgb", "feature"])
def test_adam_kernel_runs_once_a_training_step(cuda_device, case):
    """`launches.adam_update` moves by one in a phase-A and in a phase-B training step."""
    call = sync_case(case, cuda_device)
    call()                            # builds the kernels; first-use work
    launches = _build.LAUNCHES["adam_update"]
    call()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["adam_update"] == launches + 1

if __name__ == "__main__":
    torch.save(globals()[sys.argv[1]](torch.device("cuda")), sys.argv[2])
