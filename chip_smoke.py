#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU: builds the port's CUDA
kernels from this checkout, holds each against its plain PyTorch version, renders a
full-width trained scene through the port's render CLI, trains a full-width field
through the port's training CLI (phase A RGB, then phase B language features), and
times both paths.

    python3 chip_smoke.py [--seed 0]

Phases (any failure ends the run with a non-zero exit):
  1. the device: name, count, and `nvidia-smi` name and power limit;
  2. the kernels (csrc/blend_fwd.cu, blend_bwd.cu, segsum.cu) are built with nvcc, one
     process per source, all started together, then each is compared with its plain
     version at small odd sizes: the blend forward and backward with F = 0 and 3 and
     both grad modes, the segment sum with segments longer than 32;
  3. the render path: a synthetic COLMAP scene (3 cameras at 1024x768) and a trained
     model of 1M Gaussians (sh_degree 3, 3 language-feature channels, made from
     --seed) written as PLY + npz checkpoint, rendered by
     `langsplat_tpu_torch.cli.render_cli.main` for RGB and --include_feature; the
     launch counters are zeroed just before and read just after; then the forward
     kernel is compared with its plain version on the path's own full-width inputs;
  4. render timings at full width, view 0: one whole `render_full` (host clock, ending
     in a synchronize), and with CUDA events preprocess, binning and the blend kernel,
     the plain version's time, and the kernel's bound from this run's work;
  5. the training path: the same cameras over 1M SfM points of the bench box and
     language-feature maps (from --seed), trained by
     `langsplat_tpu_torch.cli.train_cli.main` for 20 phase-A steps (every Gaussian
     clones at step 10 and the capacity grows; an opacity reset at step 15) ending in a
     checkpoint, then 20 phase-B steps from it; the launch counters are zeroed before
     each phase and read after it; the original Gaussians' xyz must have moved by
     Adam's steps and the language features must have moved;
  6. full-width checks on the trained fields' view-0 inputs: the forward kernel
     against the plain forward (F = 0 on the phase-A field, F = 3 on the phase-B
     field), the backward kernel against the plain backward (full mode on the phase-A
     field, feature mode on the phase-B field), its replayed final transmittance
     against the forward kernel's bit for bit, its d_pre over two launches bit for
     bit, and the segment-sum kernel against the plain segment sum on the CPU, row by
     row, and over two launches bit for bit; the share of (instance, warp-region) pairs
     the backward kernel's cull keeps, counted with its plain mirror, which must keep
     every region the plain forward blends in;
  7. training timings at full width: per step (host clock, median of 5 after warm-up),
     its parts with CUDA events (forward render, loss, backward, optimizer), the
     device's idle share over 3 profiled steps, and the forward, backward and
     segment-sum kernels' times, plain times, bounds (each blend bound counts the
     blended pairs alone, with the count over every evaluated pair beside it), and the
     library segment sum as a yardstick.
The line before the last is the `kernels` JSON; the last line is the result JSON.
It needs one CUDA card and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

try:
    import torch
    from langsplat_tpu_torch.core import transforms
    from langsplat_tpu_torch.config import OptimizationConfig, PipelineConfig
    from langsplat_tpu_torch.data.cameras import load_camera
    from langsplat_tpu_torch.data.dataset import read_colmap_scene
    from langsplat_tpu_torch.models import field_io
    from langsplat_tpu_torch.core import losses
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    from langsplat_tpu_torch.ops import _build, projection, rasterize_cuda, segsum, tiles
    from langsplat_tpu_torch.ops.render import count_instances, render
    from langsplat_tpu_torch.train import densify, trainer
    from langsplat_tpu_torch.train.loop import BudgetPolicy, make_settings, render_full
except ImportError as e:  # run outside a checkout of the repository
    print(f"chip_smoke: cannot import the port ({e}); run it from the repository root",
          file=sys.stderr)
    sys.exit(2)

WIDTH, HEIGHT, TILE = 1024, 768, 16
N_FULL = 1_000_000
N_VIEWS = 3
FOV_X = 0.9
TOL = 2e-4            # blend forward vs plain: see tests/test_torch_cuda.py
BWD_TOL = 1e-4        # blend backward vs plain, relative to each row's largest value
SEG_TOL = 1e-5        # segment sum vs plain, relative to each row's largest sum
TRAIN_STEPS = 20
# The SfM points' 3-NN scales make ~12M instances per view at the first steps (Gaussians
# of ~50 px radius, the tile cap grown past the culled range): past the default cap of
# 6 instances per Gaussian of capacity, at which the training loop refuses to truncate.
BUDGET_FLAGS = ["--budget_factor", "24"]
SOURCES = ["blend_fwd.cu", "blend_bwd.cu", "segsum.cu"]
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM data sheet, FP32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Synthetic inputs
# ---------------------------------------------------------------------------

def bench_gaussians(n: int, rng: np.random.Generator) -> dict[str, np.ndarray]:
    """The bench scene's Gaussians (bench.py): a box in front of the cameras."""
    return dict(
        means=np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(2.5, 12, (n, 1))],
                             axis=1).astype(np.float32),
        scales=np.exp(rng.uniform(np.log(0.002), np.log(0.02), (n, 3))).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opac=rng.uniform(0.3, 0.95, n).astype(np.float32))


def trained_params(n: int, seed: int) -> dict[str, np.ndarray]:
    """Leaves of a trained-looking field: sh_degree 3 and 3 language-feature channels."""
    rng = np.random.default_rng(seed)
    g = bench_gaussians(n, rng)
    return dict(
        xyz=g["means"], features_dc=rng.normal(0, 1, (n, 1, 3)).astype(np.float32),
        features_rest=rng.normal(0, 0.2, (n, 15, 3)).astype(np.float32),
        scaling=np.log(g["scales"]), rotation=g["quats"],
        opacity=np.log(g["opac"] / (1 - g["opac"]))[:, None],
        language_feature=rng.normal(size=(n, 3)).astype(np.float32),
        alive=np.ones(n, bool))


def write_colmap_scene(root: str, seed: int, points: np.ndarray | None = None) -> None:
    """COLMAP binary model (one PINHOLE camera, N_VIEWS images looking down +z from
    slightly different positions) plus the images, as written by COLMAP. `points` are
    the SfM points (100 random ones when None), with random colours."""
    from PIL import Image
    rng = np.random.default_rng(seed + 1)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    focal = WIDTH / (2 * math.tan(FOV_X / 2))
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, WIDTH, HEIGHT))   # PINHOLE
        f.write(struct.pack("<dddd", focal, focal, WIDTH / 2, HEIGHT / 2))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", N_VIEWS))
        for i in range(N_VIEWS):
            t = (-0.15 * (i - 1), 0.05 * i, 0.0)
            f.write(struct.pack("<idddddddi", i + 1, 1.0, 0.0, 0.0, 0.0, *t, 1))
            f.write(f"view_{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    pts = rng.uniform(-3, 3, (100, 3)) if points is None else points
    # one packed record per point: id, xyz, rgb, error, track length 0
    record = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
                       ("err", "<f8"), ("track", "<u8")])
    rows = np.zeros(len(pts), record)
    rows["id"] = np.arange(1, len(pts) + 1)
    rows["xyz"] = pts
    rows["rgb"] = rng.integers(0, 256, (len(pts), 3))
    rows["err"] = 0.5
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        rows.tofile(f)
    for i in range(N_VIEWS):
        img = rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", f"view_{i:03d}.png"))


def write_language_features(root: str, seed: int, segments: int = 32) -> None:
    """Per view, the 4-level segment maps (`<image>_s.npy`, 16x16-pixel blocks with
    random segment ids, -1 for unlabelled) and unit feature table (`<image>_f.npy`)
    that the feature phase reads."""
    rng = np.random.default_rng(seed + 2)
    lf_dir = os.path.join(root, "language_features_dim3")
    os.makedirs(lf_dir)
    for i in range(N_VIEWS):
        blocks = rng.integers(-1, segments, (4, HEIGHT // 16, WIDTH // 16))
        seg = np.repeat(np.repeat(blocks, 16, axis=1), 16, axis=2).astype(np.int32)
        feats = rng.normal(size=(segments, 3))
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        np.save(os.path.join(lf_dir, f"view_{i:03d}_s.npy"), seg)
        np.save(os.path.join(lf_dir, f"view_{i:03d}_f.npy"), feats.astype(np.float32))


# ---------------------------------------------------------------------------
# Kernel vs plain
# ---------------------------------------------------------------------------

def blend_inputs(field, cam, pipe, include_feature: bool, device, sh_degree: int = 3,
                 budget: int = 0):
    """The blend's inputs for one view of `field`, as the main path builds them, with
    the instance budget and the tile cap grown until nothing is dropped (as the
    training loop's policies grow them)."""
    mats = [torch.as_tensor(m, device=device) for m in
            (cam.world_view_transform, cam.full_proj_transform, cam.camera_center)]
    prep = projection.preprocess(
        field.xyz, field.get_scaling, field.rotation, field.get_features, *mats,
        image_height=cam.height, image_width=cam.width, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, sh_degree=sh_degree, tile_size=TILE, alive=field.alive)
    opac = field.get_opacity[:, 0]
    tmax = pipe.max_tiles_per_gaussian
    while True:
        settings = make_settings(cam, pipe, sh_degree, include_feature, field.capacity,
                                 budget=budget, max_tiles=tmax)
        inst = tiles.bin_gaussians(prep, grid_x=settings.grid_x, grid_y=settings.grid_y,
                                   budget=settings.budget, tile_size=TILE,
                                   max_tiles_per_gaussian=tmax, opacities=opac)
        if int(inst.rect_dropped) and tmax < settings.grid_x * settings.grid_y:
            tmax = min(2 * tmax, settings.grid_x * settings.grid_y)
        elif int(inst.dropped):
            budget = 2 * settings.budget
        else:
            break
    feats = None
    if include_feature:
        lf = field.language_feature
        feats = lf / (torch.sqrt(torch.sum(lf * lf, dim=-1, keepdim=True) + 1e-18) + 1e-9)
    bg = torch.zeros(3, device=device)
    return settings, mats, prep, inst, rasterize_cuda.blend_args(prep, inst, opac, feats, bg)


def compare(args, h, w) -> float:
    """Max abs error of the kernel against the plain version on the same inputs."""
    size = dict(image_height=h, image_width=w, tile_size=TILE)
    image, t_final = rasterize_cuda.blend_forward_cuda(*args, **size)
    torch.cuda.synchronize()
    ref_image, ref_t = rasterize_cuda.blend_forward_plain(*args, **size)
    if not (torch.isfinite(image).all() and torch.isfinite(t_final).all()):
        raise RuntimeError("blend kernel produced non-finite values")
    return max(float((image - ref_image).abs().max()), float((t_final - ref_t).abs().max()))


def backward_inputs(args, inst, h, w, target, mask=None):
    """The backward's inputs for the blend `args`: the forward kernel's outputs and the
    gradients of the training loss against `target` (the RGB loss of phase A, or, with
    `mask`, the masked feature L1 of phase B)."""
    size = dict(image_height=h, image_width=w, tile_size=TILE)
    image, t_final = rasterize_cuda.blend_forward_cuda(*args, **size)
    img = image.detach().requires_grad_(True)
    if mask is None:
        loss = losses.rgb_loss(img[:3], target)
    else:
        loss = losses.masked_l1_loss(img[3:], target, mask)
    (g_image,) = torch.autograd.grad(loss, [img])
    g_t = torch.zeros_like(t_final)
    g_tfinal, total = rasterize_cuda.backward_residuals(image, t_final, args[8], g_image,
                                                        g_t)
    return (*args[:8], inst.presort_slot, g_image.contiguous(), g_tfinal, total,
            t_final), t_final


def compare_backward(bwd_args, t_final, grad_mode, h, w) -> tuple[float, float, torch.Tensor]:
    """(max abs error, largest row-relative error) of the backward kernel against the
    plain backward, checking its replayed final T against the forward kernel's bit for
    bit; also returns the kernel's d_pre."""
    size = dict(image_height=h, image_width=w, tile_size=TILE, grad_mode=grad_mode,
                return_t=True)
    d_pre, t_replay = rasterize_cuda.blend_backward_cuda(*bwd_args, **size)
    torch.cuda.synchronize()
    if not torch.equal(t_replay, t_final):
        bad = int((t_replay != t_final).sum())
        raise RuntimeError(f"backward kernel's replayed T differs from the forward "
                           f"kernel's at {bad} pixels")
    ref, _ = rasterize_cuda.blend_backward_plain(*bwd_args, **size)
    if not torch.isfinite(d_pre).all():
        raise RuntimeError("backward kernel produced non-finite values")
    err = (d_pre - ref).abs()
    scale = ref.abs().amax(dim=1, keepdim=True).clamp_min(1e-12)
    return float(err.max()), float((err / scale).max()), d_pre


def compare_segsum(d_pre, ends, n) -> tuple[float, float, list]:
    """(max abs error, largest row-relative error, each row's largest sum) of the
    segment-sum kernel against the plain version run on the CPU, which adds each
    segment's columns in ascending order as the kernel does (on the card, index_add_
    adds in the order its atomics land); raises when an error exceeds SEG_TOL of its
    row's largest sum."""
    out = segsum.segment_sum_cuda(d_pre, ends, n).cpu()
    ref = segsum.segment_sum_plain(d_pre.cpu(), ends.cpu(), n)
    if not torch.isfinite(out).all():
        raise RuntimeError("segsum kernel produced non-finite values")
    err = (out - ref).abs()
    scale = ref.abs().amax(dim=1, keepdim=True)
    rel = float((err / scale.clamp_min(1e-30)).max())
    if not rel <= SEG_TOL:
        raise RuntimeError(f"segsum kernel disagrees with its plain version: "
                           f"row-relative {rel}")
    return float(err.max()), rel, [float(s) for s in scale[:, 0]]


def small_comparisons(device) -> dict:
    """Each kernel against its plain version at small odd sizes: the blend forward and
    backward on random scenes with F = 0 and 3 (the backward in both grad modes), the
    segment sum on random segments with some longer than 32. Returns the worst errors:
    absolute for the forward, absolute and row-relative for the backward and the
    segment sum."""
    worst = dict(blend_fwd=0.0, blend_bwd=0.0, blend_bwd_abs=0.0, segsum=0.0,
                 segsum_abs=0.0)
    for n, w, h, seed in ((2000, 77, 53, 1), (20000, 333, 211, 2)):
        rng = np.random.default_rng(seed)
        g = {k: torch.tensor(v, device=device) for k, v in bench_gaussians(n, rng).items()}
        g["scales"] = g["scales"] * 8.0      # fewer, larger splats on a small image
        view = transforms.world_to_view(np.eye(3), np.zeros(3)).T
        proj = view @ transforms.projection_matrix(0.01, 100.0, FOV_X, FOV_X * h / w).T
        tan_x, tan_y = math.tan(FOV_X / 2), math.tan(FOV_X * h / w / 2)
        prep = projection.preprocess(
            g["means"], g["scales"], g["quats"], None, torch.tensor(view, device=device),
            torch.tensor(proj, device=device),
            torch.tensor(np.linalg.inv(view)[3, :3], device=device),
            image_height=h, image_width=w, tanfovx=tan_x, tanfovy=tan_y, sh_degree=0,
            tile_size=TILE, colors_precomp=torch.rand((n, 3), device=device))
        inst = tiles.bin_gaussians(prep, grid_x=-(-w // TILE), grid_y=-(-h // TILE),
                                   budget=64 * n, tile_size=TILE, opacities=g["opac"])
        target = torch.rand((3, h, w), device=device)
        mask = (torch.rand((1, h, w), device=device) < 0.8).float()
        for num_feat in (0, 3):
            feats = (torch.nn.functional.normalize(torch.randn((n, 3), device=device),
                                                   dim=1) if num_feat else None)
            args = rasterize_cuda.blend_args(prep, inst, g["opac"], feats,
                                             torch.rand(3, device=device))
            err = compare(args, h, w)
            log(f"  blend_fwd vs plain {w}x{h} n={n} F={num_feat}: max_abs_err "
                f"{err:.3e} (tol {TOL:.0e})")
            worst["blend_fwd"] = max(worst["blend_fwd"], err)
            for mode in ("full", "feature") if num_feat else ("full",):
                bwd_args, t_final = backward_inputs(
                    args, inst, h, w, target, mask if mode == "feature" else None)
                abs_err, rel_err, d_pre = compare_backward(bwd_args, t_final, mode, h, w)
                log(f"  blend_bwd vs plain {w}x{h} n={n} F={num_feat} {mode}: "
                    f"max_abs_err {abs_err:.3e}, row-relative {rel_err:.3e} "
                    f"(tol {BWD_TOL:.0e}); replayed T bit-equal")
                worst["blend_bwd"] = max(worst["blend_bwd"], rel_err)
                worst["blend_bwd_abs"] = max(worst["blend_bwd_abs"], abs_err)
                ends = torch.clamp(inst.gauss_offsets, 0, inst.gauss_id.shape[0])
                seg_abs, seg_rel, _ = compare_segsum(d_pre, ends, n)
                worst["segsum"] = max(worst["segsum"], seg_rel)
                worst["segsum_abs"] = max(worst["segsum_abs"], seg_abs)
    # segments longer than 32 (the tile cap grows up to the whole grid)
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 4, 20000)
    lengths[rng.integers(0, 20000, 50)] = rng.integers(33, 400, 50)
    ends = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32,
                        device=device)
    d_pre = torch.randn((12, int(ends[-1]) + 5), device=device)
    seg_abs, seg_rel, _ = compare_segsum(d_pre, ends, 20000)
    log(f"  segsum vs plain, 20000 segments (50 of 33-399): max_abs_err {seg_abs:.3e}, "
        f"row-relative {seg_rel:.3e} (tol {SEG_TOL:.0e}); and on the backward's d_pre "
        f"above: row-relative {worst['segsum']:.3e}")
    worst["segsum"] = max(worst["segsum"], seg_rel)
    worst["segsum_abs"] = max(worst["segsum_abs"], seg_abs)
    return worst


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """Wall time per call of `fn` (ending in a device synchronize)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profile_render(fn, reps: int = 3) -> dict:
    """Device time by kernel over `reps` calls of `fn` (a render or a training step;
    torch.profiler), and the share of the window's wall time in which the device ran no
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    device_us = sum(t for _, t in kernels)
    return dict(wall_ms_per_call=wall_us / reps / 1e3,
                device_ms_per_call=device_us / reps / 1e3,
                device_idle_share=1.0 - device_us / wall_us,
                top_kernels_ms_per_call=[(k[:60], t / reps / 1e3) for k, t in kernels[:8]])


def bounds(nbytes: int, ops: int, ops_evaluated: int) -> tuple[float, str, dict]:
    """(bound ms, what sets it, work): the larger of bytes over the HBM rate and FP32
    operations over the FP32 peak, the operations being those of the blended pairs alone
    (what the function needs: a kernel that culls exactly evaluates no other pair); beside
    it, as `bound_evaluated_ms`, the same with the falloff of every evaluated pair, which
    a kernel without a cull does."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    work = dict(bytes=nbytes, fp32_ops=ops, fp32_ops_evaluated=ops_evaluated,
                bound_evaluated_ms=max(t_bytes, ops_evaluated / FP32_OPS_PER_S * 1e3))
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), work


def blend_bound(args, h, w, num_instances: int, pairs) -> tuple[float, str, dict]:
    """Least time for the blend on this card (`bounds`). Bytes: every input read once
    (per-Gaussian arrays, the instances the tiles list, tile ranges, bg) and both outputs
    written once. Operations: from the (evaluated, blended) (instance, pixel) pairs these
    inputs need, counted by the plain version: 11 per blended pair (offsets and the
    conic power) and 6 + 2C more (alpha, transmittance, weight, C accumulations); the
    evaluated count adds the 11 of every evaluated pair that does not blend."""
    means2d, conics, opac, visible, colors, feats, gauss_id, tile_start, bg = args
    c = 3 + (0 if feats is None else feats.shape[1])
    n = means2d.shape[0]
    in_bytes = (n * 4 * (2 + 3 + 1 + 3 + (c - 3)) + n + 4 * num_instances
                + 4 * tile_start.numel() + 4 * 3)
    out_bytes = 4 * (c + 1) * h * w
    evaluated, blended = pairs
    bound, bound_by, work = bounds(in_bytes + out_bytes,
                                   (11 + 6 + 2 * c) * blended,
                                   11 * evaluated + (6 + 2 * c) * blended)
    return bound, bound_by, dict(work, evaluated_pairs=evaluated, blended_pairs=blended)


def backward_bound(bwd_args, grad_mode, h, w, num_instances: int, pairs,
                   ) -> tuple[float, str, dict]:
    """Least time for the blend backward on this card, counted like `blend_bound`.
    Bytes: the forward's per-Gaussian inputs, the instances the tiles list and their
    pre-sort slots, tile ranges, the per-pixel gradients and residuals (C + 3 floats a
    pixel) read once, and d_pre [R, budget] written once. Operations, from the forward's
    (evaluated, blended) pairs on the same inputs, per blended pair: 11 (the falloff),
    30 + 3C (alpha, T, weight, gdot, the suffix, dalpha and its chain to the six
    geometric gradients, the C attribute gradients) and one add per output row into the
    instance's sum; in feature mode 11 + 6 + 2F. The evaluated count adds the 11 of
    every evaluated pair that does not blend."""
    means2d, _, _, _, _, feats, _, tile_start = bwd_args[:8]
    num_feat = 0 if feats is None else feats.shape[1]
    c = 3 + num_feat
    rows = rasterize_cuda.grad_rows(num_feat, grad_mode)
    n = means2d.shape[0]
    budget = bwd_args[6].shape[0]
    in_bytes = (n * 4 * (2 + 3 + 1 + 3 + num_feat) + n + 8 * num_instances
                + 4 * tile_start.numel() + 4 * (c + 3) * h * w)
    out_bytes = 4 * rows * budget
    evaluated, blended = pairs
    per_blended = (30 + 3 * c + rows) if grad_mode == "full" else (6 + 2 * num_feat)
    bound, bound_by, work = bounds(in_bytes + out_bytes,
                                   (11 + per_blended) * blended,
                                   11 * evaluated + per_blended * blended)
    return bound, bound_by, dict(work, evaluated_pairs=evaluated, blended_pairs=blended)


def cull_shares(bargs, inst, blended_in, chunk: int = 1 << 21) -> dict:
    """The share of (instance, warp-region) pairs that the backward kernel's cull keeps,
    counted with its plain mirror on these inputs, beside the share that the plain
    forward blends; raises if the cull would skip a region an instance blends in."""
    means2d, conics, opac, visible = bargs[:4]
    num = int(inst.num_instances)
    kept = blended = missed = 0
    for lo in range(0, num, chunk):
        hi = min(num, lo + chunk)
        keep = rasterize_cuda.warp_region_keep(
            means2d, conics, opac, visible, inst.gauss_id[lo:hi], inst.tile_id[lo:hi],
            grid_x=-(-WIDTH // TILE))
        hit = blended_in[lo:hi]
        kept += int(keep.sum())
        blended += int(hit.sum())
        missed += int((hit & ~keep).sum())
    if missed:
        raise RuntimeError(f"the backward kernel's cull skips {missed} (instance, "
                           f"region) pairs that blend")
    regions = blended_in.shape[1]
    return dict(cull_kept_share=kept / max(num * regions, 1),
                blended_region_share=blended / max(num * regions, 1))


def segsum_bound(d_pre, ends, n) -> tuple[float, str, dict]:
    """Least time for the segment sum: the covered columns of d_pre and `ends` read once,
    the [rows, n] result written once (one add per element read: far below the FP32
    rate, so bytes set it)."""
    rows = d_pre.shape[0]
    covered = int(ends[-1] - ends[0])
    nbytes = 4 * rows * covered + 4 * ends.numel() + 4 * rows * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = rows * covered / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            dict(bytes=nbytes, columns=covered))


def library_segment_sum_ms(d_pre, ends, n):
    """One PyTorch call for the same segment sum, `torch.segment_reduce` with offsets,
    timed as a yardstick (the port never calls it); its input is laid out [columns,
    rows] beforehand. None if the call is not available here."""
    lo, hi = int(ends[0]), int(ends[-1])
    data = d_pre[:, lo:hi].T.contiguous()
    offsets = (ends - lo).to(torch.int64)
    try:
        out = torch.segment_reduce(data, "sum", offsets=offsets, axis=0, unsafe=True)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        log(f"  torch.segment_reduce unavailable: {e}")
        return None
    ref = segsum.segment_sum_cuda(d_pre, ends, n).T
    if out.shape != ref.shape or not torch.allclose(out, ref, atol=1e-5, rtol=1e-5):
        raise RuntimeError("torch.segment_reduce disagrees with the segsum kernel")
    return cuda_ms(lambda: torch.segment_reduce(data, "sum", offsets=offsets, axis=0,
                                                unsafe=True), reps=10)


# ---------------------------------------------------------------------------
# The training path
# ---------------------------------------------------------------------------

def phase_a_flags(scene_dir, model_dir):
    """20 phase-A steps; densification fires at step 10 and the opacity reset at 15.
    The densification threshold is 0 and every scale counts as small, so every alive
    Gaussian clones: the N_FULL originals keep their slots, their clones fill the
    N_FULL / 2 free slots, the other half overflow, and the capacity grows by 1.5x."""
    return ["-s", scene_dir, "-m", model_dir, "--no_include_feature", "--quiet",
            "--iterations", str(TRAIN_STEPS), "--sh_degree", "3", *BUDGET_FLAGS,
            "--densify_from_iter", "5", "--densification_interval", "10",
            "--densify_until_iter", "18", "--opacity_reset_interval", "15",
            "--densify_grad_threshold", "0", "--percent_dense", "1000",
            "--test_iterations", "999999", "--save_iterations", str(TRAIN_STEPS),
            "--checkpoint_iterations", str(TRAIN_STEPS)]


def run_training_phase(name, argv, logs):
    """Run the training CLI with the launch counters zeroed just before and read just
    after; every kernel of the path must have launched at least once per step."""
    from langsplat_tpu_torch.cli.train_cli import main as train_main
    for key in _build.LAUNCHES:
        _build.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    result = train_main(argv)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    seconds = time.perf_counter() - t0
    history = result["history"]
    log(f"phase 5 ({name}): {len(history)} steps in {seconds:.1f} s; launches "
        f"{launches}; loss first {history[0]:.5f} last {history[-1]:.5f}; "
        f"{result['field'].num_alive} alive of {result['field'].capacity}")
    if len(history) != TRAIN_STEPS or not np.all(np.isfinite(history)):
        raise RuntimeError(f"{name}: bad loss history {history}")
    for key in ("blend_fwd", "blend_bwd", "segsum"):
        if launches[key] < TRAIN_STEPS:
            raise RuntimeError(f"{name}: {key} launched {launches[key]} times in "
                               f"{TRAIN_STEPS} steps")
    logs[name] = dict(seconds=seconds, launches=launches, loss_first=history[0],
                      loss_last=history[-1], alive=result["field"].num_alive,
                      capacity=result["field"].capacity)
    return result


def step_parts_ms(field, opt_state, stats, cam, settings, optimizer, phase, gt, mask,
                  bg):
    """One training step split by CUDA events into forward render, loss, backward
    (K2 and K3 inside) and optimizer (with the statistics update)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    mats = [torch.as_tensor(m, device=field.device) for m in
            (cam.world_view_transform, cam.full_proj_transform, cam.camera_center)]
    feature = phase == "B"
    torch.cuda.synchronize()
    events[0].record()
    params = {k: v.detach().requires_grad_(True)
              for k, v in trainer.extract_params(field, feature).items()}
    tap = None if feature else torch.zeros((field.capacity, 2), device=field.device,
                                           requires_grad=True)
    out = render(trainer.merge_params(field, params), settings, *mats, bg,
                 screenspace_offset=tap)
    events[1].record()
    if feature:
        loss = losses.masked_l1_loss(out["language_feature_image"], gt, mask)
    else:
        loss = losses.rgb_loss(out["render"], gt)
    events[2].record()
    wrt = list(params.values()) + ([] if feature else [tap])
    grads = torch.autograd.grad(loss, wrt)
    events[3].record()
    with torch.no_grad():
        optimizer.update(dict(zip(params, grads)), opt_state,
                         trainer.extract_params(field, feature))
        if not feature:
            densify.update_stats(stats, grads[-1], out["visibility_filter"], out["radii"],
                                 settings.image_width, settings.image_height)
    events[4].record()
    torch.cuda.synchronize()
    names = ("forward_render_ms", "loss_ms", "backward_ms", "optimizer_ms")
    return {k: events[i].elapsed_time(events[i + 1]) for i, k in enumerate(names)}


def train_step_fn(field, opt_state, stats, cam, settings, optimizer, phase, gt, mask, bg):
    mats = [torch.as_tensor(m, device=field.device) for m in
            (cam.world_view_transform, cam.full_proj_transform, cam.camera_center)]
    if phase == "B":
        return lambda: trainer.train_step_feature(field, opt_state, stats, *mats, gt, mask,
                                                  bg, settings=settings,
                                                  optimizer=optimizer)
    return lambda: trainer.train_step_rgb(field, opt_state, stats, *mats, gt, bg,
                                          settings=settings, optimizer=optimizer,
                                          lambda_dssim=0.2)


def median_step_ms(fn, reps: int = 5) -> tuple[float, list]:
    """Median host-clock time of `fn` (each call ending in a synchronize) after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def training_checks_and_timings(phase, result, cam, pipe, device, target, mask):
    """Phases 6 and 7 for one trained field: the forward, backward and segment-sum
    kernels against their plain versions on the field's view-0 inputs (replayed T
    bit-equal to the forward's), then the step timings and the kernels' times and
    bounds."""
    field = result["field"]
    feature = phase == "B"
    mode = "feature" if feature else "full"
    optimizer = trainer.make_optimizer(OptimizationConfig(),
                                       result["scene"].cameras_extent, feature)
    opt_state = result["opt_state"]
    stats = result["stats"]
    budget_policy = BudgetPolicy(pipe, field.capacity)
    probe = make_settings(cam, pipe, 0, feature, field.capacity,
                          budget=BudgetPolicy.GRANULE)
    mats = [torch.as_tensor(m, device=device) for m in
            (cam.world_view_transform, cam.full_proj_transform, cam.camera_center)]
    with torch.no_grad():
        budget_policy.resize(field.capacity, count_instances(field, probe, *mats))
    budget = budget_policy.budget
    size = dict(image_height=HEIGHT, image_width=WIDTH, tile_size=TILE)
    with torch.no_grad():
        settings, _, prep, inst, bargs = blend_inputs(field, cam, pipe, feature, device,
                                                      sh_degree=0, budget=budget)
    budget = settings.budget
    num_instances = int(inst.num_instances)
    with torch.no_grad():
        fwd_err = compare(bargs, HEIGHT, WIDTH)
    log(f"phase 6 ({phase}): blend_fwd (F={3 if feature else 0}) vs plain on view 0 at "
        f"full width, {num_instances} instances: max_abs_err {fwd_err:.3e} "
        f"(tol {TOL:.0e})")
    if not fwd_err <= TOL:
        raise RuntimeError(f"blend_fwd disagrees with its plain version: {fwd_err}")
    bwd_args, t_final = backward_inputs(bargs, inst, HEIGHT, WIDTH, target,
                                        mask if feature else None)
    abs_err, rel_err, d_pre = compare_backward(bwd_args, t_final, mode, HEIGHT, WIDTH)
    log(f"phase 6 ({phase}): blend_bwd ({mode}) vs plain on view 0 at full width, "
        f"{num_instances} instances: max_abs_err {abs_err:.3e}, row-relative "
        f"{rel_err:.3e} (tol {BWD_TOL:.0e}); replayed T equals the forward's bit for bit")
    if not rel_err <= BWD_TOL:
        raise RuntimeError(f"blend_bwd disagrees with its plain version: {rel_err}")
    bwd_kw = dict(grad_mode=mode, **size)
    again = rasterize_cuda.blend_backward_cuda(*bwd_args, **bwd_kw)
    if not torch.equal(again, d_pre):
        raise RuntimeError("blend_bwd gave different d_pre in two launches")
    n = field.capacity
    ends = torch.clamp(inst.gauss_offsets, 0, inst.gauss_id.shape[0]).contiguous()
    seg_err, seg_rel, seg_scale = compare_segsum(d_pre, ends, n)
    if not torch.equal(segsum.segment_sum_cuda(d_pre, ends, n),
                       segsum.segment_sum_cuda(d_pre, ends, n)):
        raise RuntimeError("segsum gave different sums in two launches")
    log(f"phase 6 ({phase}): blend_bwd launched twice: d_pre bit-equal; segsum vs plain "
        f"(CPU) on the same d_pre: max_abs_err {seg_err:.3e}, row-relative "
        f"{seg_rel:.3e} (tol {SEG_TOL:.0e}), bit-equal over two launches; each row's "
        f"largest sum " + ", ".join(f"{s:.2e}" for s in seg_scale))
    evaluated, blended, blended_in = rasterize_cuda.blend_pairs(*bargs, **size)
    pairs = (evaluated, blended)
    shares = cull_shares(bargs, inst, blended_in)
    del blended_in
    log(f"phase 6 ({phase}): the backward's cull keeps {shares['cull_kept_share']:.4f} of "
        f"the (instance, warp-region) pairs; the plain forward blends in "
        f"{shares['blended_region_share']:.4f}; none it blends in is skipped")

    # 7. timings
    gt = target
    step = train_step_fn(field, opt_state, stats, cam, settings, optimizer, phase, gt,
                         mask, torch.zeros(3, device=device))
    step_ms, step_all = median_step_ms(step)
    parts = [step_parts_ms(field, opt_state, stats, cam, settings, optimizer, phase, gt,
                           mask, torch.zeros(3, device=device)) for _ in range(3)]
    parts = {k: float(np.median([p[k] for p in parts])) for k in parts[0]}
    timing = dict(
        capacity=n, alive=field.num_alive, budget=budget, instances=num_instances,
        step_ms=step_ms, step_ms_all=step_all, **parts,
        blend_fwd_ms=cuda_ms(lambda: rasterize_cuda.blend_forward_cuda(*bargs, **size),
                             reps=10),
        blend_bwd_ms=cuda_ms(lambda: rasterize_cuda.blend_backward_cuda(*bwd_args,
                                                                        **bwd_kw), reps=10),
        blend_bwd_plain_ms=cuda_ms(lambda: rasterize_cuda.blend_backward_plain(
            *bwd_args, **bwd_kw), reps=1),
        segsum_ms=cuda_ms(lambda: segsum.segment_sum_cuda(d_pre, ends, n), reps=20),
        segsum_plain_ms=cuda_ms(lambda: segsum.segment_sum_plain(d_pre, ends, n), reps=5),
        segsum_library_ms=library_segment_sum_ms(d_pre, ends, n))
    bound, bound_by, work = backward_bound(bwd_args, mode, HEIGHT, WIDTH, num_instances,
                                           pairs)
    timing.update(blend_bwd_bound_ms=bound, blend_bwd_bound_by=bound_by,
                  blend_bwd_work=work, **shares)
    fbound, fbound_by, fwork = blend_bound(bargs, HEIGHT, WIDTH, num_instances, pairs)
    timing.update(blend_fwd_bound_ms=fbound, blend_fwd_bound_by=fbound_by,
                  blend_fwd_work=fwork)
    sbound, sbound_by, swork = segsum_bound(d_pre, ends, n)
    timing.update(segsum_bound_ms=sbound, segsum_bound_by=sbound_by, segsum_work=swork)
    log(f"phase 7 ({phase}): " + json.dumps(timing))
    log(f"phase 7 ({phase}) profile over 3 steps: " + json.dumps(profile_render(step)))
    return dict(timing, errors=dict(blend_fwd=fwd_err, blend_bwd=abs_err,
                                    blend_bwd_rel=rel_err, segsum=seg_err,
                                    segsum_rel=seg_rel))


# ---------------------------------------------------------------------------

def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.manual_seed(args.seed)

    # 1. the device
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} x{count}; torch {torch.__version__} CUDA {torch.version.cuda}")

    # 2. build and compare on small scenes
    t0 = time.perf_counter()
    _build.build(SOURCES)
    log(f"phase 2: built {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s")
    small = small_comparisons(device)
    errors = dict(blend_fwd=small["blend_fwd"], blend_bwd=small["blend_bwd_abs"],
                  blend_bwd_rel=small["blend_bwd"], segsum=small["segsum_abs"],
                  segsum_rel=small["segsum"])
    if not (small["blend_fwd"] <= TOL and small["blend_bwd"] <= BWD_TOL):
        raise RuntimeError(f"a kernel disagrees with its plain version: {small}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 3. the render path: the render CLI at full width
        from langsplat_tpu_torch.cli.render_cli import main as render_main
        scene_dir, model_dir = os.path.join(tmp, "scene"), os.path.join(tmp, "model")
        t0 = time.perf_counter()
        write_colmap_scene(scene_dir, args.seed)
        field = from_numpy(trained_params(N_FULL, args.seed), "cpu")
        field_io.save_ply(field, os.path.join(model_dir, "point_cloud", "iteration_1",
                                              "point_cloud.ply"))
        field_io.save_field(os.path.join(model_dir, "chkpnt1.npz"), field, step=1,
                            spatial_lr_scale=1.0, active_sh_degree=3)
        log(f"phase 3: wrote scene + {N_FULL}-Gaussian model in "
            f"{time.perf_counter() - t0:.1f} s")

        for key in _build.LAUNCHES:
            _build.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        render_main(["-m", model_dir, "-s", scene_dir, "--skip_test"])
        render_main(["-m", model_dir, "-s", scene_dir, "--skip_test", "--include_feature"])
        torch.cuda.synchronize()
        render_launches = dict(_build.LAUNCHES)
        cli_s = time.perf_counter() - t0
        log(f"phase 3: render CLI, {N_VIEWS} views x (RGB, features) in {cli_s:.1f} s; "
            f"launches {render_launches}")
        if render_launches["blend_fwd"] < 2 * N_VIEWS:
            raise RuntimeError(f"blend kernel launched {render_launches['blend_fwd']} "
                               f"times on the render path, expected >= {2 * N_VIEWS}")
        out_dir = os.path.join(model_dir, "train", "ours_1", "renders_npy")
        outs = [np.load(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))]
        if len(outs) != N_VIEWS:
            raise RuntimeError(f"expected {N_VIEWS} renders, found {len(outs)}")
        for o in outs:
            if o.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(o).all():
                raise RuntimeError(f"bad render: shape {o.shape}")
            if float(o.std()) < 1e-3:
                raise RuntimeError("render is flat: nothing was drawn")

        # the render path's own inputs (view 0, features), kernel vs plain
        cam = load_camera(read_colmap_scene(scene_dir).train_cameras[0], 1.0, -1, uid=0)
        gpu_field = field.to(device)
        pipe = PipelineConfig()
        with torch.no_grad():
            runs = {f: blend_inputs(gpu_field, cam, pipe, f, device)
                    for f in (False, True)}
            full_err = compare(runs[True][4], HEIGHT, WIDTH)
        log(f"phase 3: blend_fwd vs plain on view 0 at full width (F=3): "
            f"max_abs_err {full_err:.3e} (tol {TOL:.0e})")
        errors["blend_fwd"] = max(errors["blend_fwd"], full_err)
        if not errors["blend_fwd"] <= TOL:
            raise RuntimeError(f"blend_fwd disagrees with its plain version: "
                               f"{errors['blend_fwd']} > {TOL}")

        # 4. render timings at full width (view 0); fewer reps than the first slice's
        timings = {}
        with torch.no_grad():
            for feat, (settings, mats, prep, inst, bargs) in runs.items():
                mode = "features" if feat else "rgb"
                size = dict(image_height=HEIGHT, image_width=WIDTH, tile_size=TILE)
                timings[mode] = dict(
                    instances=int(inst.num_instances),
                    render_full_ms=host_ms(lambda: render_full(
                        gpu_field, cam, pipe, 3, feat, [0.0, 0.0, 0.0], device=device),
                        reps=3),
                    preprocess_ms=cuda_ms(lambda: projection.preprocess(
                        gpu_field.xyz, gpu_field.get_scaling, gpu_field.rotation,
                        gpu_field.get_features, *mats, image_height=HEIGHT,
                        image_width=WIDTH, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                        sh_degree=3, tile_size=TILE, alive=gpu_field.alive), reps=5),
                    binning_ms=cuda_ms(lambda: tiles.bin_gaussians(
                        prep, grid_x=settings.grid_x, grid_y=settings.grid_y,
                        budget=settings.budget, tile_size=TILE,
                        max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
                        opacities=bargs[2]), reps=3),
                    blend_ms=cuda_ms(lambda: rasterize_cuda.blend_forward_cuda(
                        *bargs, **size), reps=20),
                    plain_ms=cuda_ms(lambda: rasterize_cuda.blend_forward_plain(
                        *bargs, **size), reps=1))
                evaluated, blended, _ = rasterize_cuda.blend_pairs(*bargs, **size)
                bound, bound_by, work = blend_bound(bargs, HEIGHT, WIDTH,
                                                    int(inst.num_instances),
                                                    (evaluated, blended))
                timings[mode].update(bound_ms=bound, bound_by=bound_by, **work)
                # the backward on this opaque trained field (pixels end early), for
                # comparison with the training runs' fields
                grad_mode = "feature" if feat else "full"
                with torch.enable_grad():
                    bwd_args, _ = backward_inputs(
                        bargs, inst, HEIGHT, WIDTH, torch.rand((3, HEIGHT, WIDTH),
                                                               device=device),
                        torch.ones((1, HEIGHT, WIDTH), device=device) if feat else None)
                timings[mode]["blend_bwd_ms"] = cuda_ms(
                    lambda: rasterize_cuda.blend_backward_cuda(
                        *bwd_args, grad_mode=grad_mode, **size), reps=10)
                timings[mode]["blend_bwd_bound_ms"] = backward_bound(
                    bwd_args, grad_mode, HEIGHT, WIDTH, int(inst.num_instances),
                    (work["evaluated_pairs"], work["blended_pairs"]))[0]
                log(f"phase 4 ({mode}): " + json.dumps(timings[mode]))
                log(f"phase 4 ({mode}) profile: " + json.dumps(profile_render(
                    lambda: render_full(gpu_field, cam, pipe, 3, feat, [0.0, 0.0, 0.0],
                                        device=device))))
        del gpu_field, runs, field

        # 5. the training path: the train CLI at full width, phase A then phase B
        train_scene = os.path.join(tmp, "train_scene")
        run_prefix = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        points = bench_gaussians(N_FULL, np.random.default_rng(args.seed))["means"]
        write_colmap_scene(train_scene, args.seed, points=points.astype(np.float64))
        write_language_features(train_scene, args.seed)
        log(f"phase 5: wrote the training scene ({N_FULL} SfM points, language "
            f"features) in {time.perf_counter() - t0:.1f} s")
        train_logs = {}
        result_a = run_training_phase("A", phase_a_flags(train_scene, run_prefix),
                                      train_logs)
        # densification grew the capacity and left the originals in their slots, so
        # their moves are Adam's alone: at most ~5 lr a step (lr <= position_lr_init
        # times the scene extent)
        field_a = result_a["field"]
        start_capacity = int(N_FULL * OptimizationConfig().initial_capacity_factor)
        log(f"phase 5 (A): capacity {start_capacity} -> {field_a.capacity}, "
            f"{field_a.num_alive} alive")
        if not (field_a.capacity > start_capacity and field_a.num_alive > N_FULL
                and bool(field_a.alive[:N_FULL].all())):
            raise RuntimeError("densification did not clone into a grown capacity")
        step_a = (field_a.xyz[:N_FULL]
                  - torch.as_tensor(points, dtype=torch.float32, device=device)).abs()
        moved_a = float(step_a.max())
        moved_share = float((step_a.amax(dim=1) > 0).float().mean())
        xyz_limit = (5 * TRAIN_STEPS * OptimizationConfig().position_lr_init
                     * result_a["scene"].cameras_extent)
        checkpoint = os.path.join(run_prefix + "_-1", f"chkpnt{TRAIN_STEPS}.npz")
        result_b = run_training_phase(
            "B", ["-s", train_scene, "-m", run_prefix, "--quiet", "--feature_level", "1",
                  "--iterations", str(TRAIN_STEPS), "--sh_degree", "3", *BUDGET_FLAGS,
                  "--start_checkpoint", checkpoint, "--test_iterations", "999999",
                  "--save_iterations", str(TRAIN_STEPS),
                  "--checkpoint_iterations", str(TRAIN_STEPS)], train_logs)
        init_lf = 1e-2 * torch.randn((result_b["field"].capacity, 3),
                                     generator=torch.Generator().manual_seed(0))
        moved_b = float((result_b["field"].language_feature.cpu() - init_lf).abs().max())
        log(f"phase 5: parameters moved: xyz of {moved_share:.3f} of the original "
            f"Gaussians by up to {moved_a:.3e} (limit {xyz_limit:.3e}; phase A), "
            f"language features by up to {moved_b:.3e} (phase B)")
        if not (0 < moved_a <= xyz_limit and moved_share > 0.1 and moved_b > 0):
            raise RuntimeError("training did not move the parameters as Adam would")
        if not os.path.exists(os.path.join(run_prefix + "_1", f"chkpnt{TRAIN_STEPS}.npz")):
            raise RuntimeError("phase B wrote no checkpoint")

        # 6 + 7. full-width checks and timings on the trained fields, view 0
        train_cam = result_a["scene"].get_train_cameras()[0]
        target = torch.as_tensor(train_cam.image).to(device)
        gt_feat, gt_mask = train_cam.get_language_feature(
            os.path.join(train_scene, "language_features_dim3"), 1)
        pipe = PipelineConfig(budget_factor=int(BUDGET_FLAGS[1]))
        train_timings = {}
        train_timings["A"] = training_checks_and_timings(
            "A", result_a, train_cam, pipe, device, target, None)
        del result_a
        train_timings["B"] = training_checks_and_timings(
            "B", result_b, train_cam, pipe, device, torch.as_tensor(gt_feat).to(device),
            torch.as_tensor(gt_mask).to(device))
    for ph in ("A", "B"):
        for key, err in train_timings[ph]["errors"].items():
            errors[key] = max(errors[key], err)
    if not (errors["blend_fwd"] <= TOL and errors["blend_bwd_rel"] <= BWD_TOL
            and errors["segsum_rel"] <= SEG_TOL):
        raise RuntimeError(f"a kernel disagrees with its plain version: {errors}")

    feat = timings["features"]
    ta, tb = train_timings["A"], train_timings["B"]
    launches = {k: train_logs["A"]["launches"][k] + train_logs["B"]["launches"][k]
                for k in ("blend_bwd", "segsum")}
    # `max_abs_err` is absolute for every kernel; each is held to `tol` of the kind
    # `tol_of` names, against `max_rel_err` where that is row-relative; the numbers
    # after `tol_of` are the same kernel on the training path's view 0 (phase A, B)
    kernels = [
        dict(name="blend_fwd", route="cuda", source="langsplat_tpu_torch/csrc/blend_fwd.cu",
             replaces="langsplat_tpu/ops/rasterize_pallas.py:597",
             launches=render_launches["blend_fwd"] + train_logs["A"]["launches"][
                 "blend_fwd"] + train_logs["B"]["launches"]["blend_fwd"],
             max_abs_err=errors["blend_fwd"],
             ms=feat["blend_ms"], plain_ms=feat["plain_ms"], bound_ms=feat["bound_ms"],
             bound_by=feat["bound_by"], library_ms=None, tol=TOL, tol_of="absolute",
             bound_counts="blended pairs",
             bound_evaluated_ms=feat["bound_evaluated_ms"],
             train_ms=[ta["blend_fwd_ms"], tb["blend_fwd_ms"]],
             train_bound_ms=[ta["blend_fwd_bound_ms"], tb["blend_fwd_bound_ms"]],
             train_bound_evaluated_ms=[t["blend_fwd_work"]["bound_evaluated_ms"]
                                       for t in (ta, tb)]),
        dict(name="blend_bwd", route="cuda", source="langsplat_tpu_torch/csrc/blend_bwd.cu",
             replaces="langsplat_tpu/ops/rasterize_pallas.py:746",
             launches=launches["blend_bwd"], max_abs_err=errors["blend_bwd"],
             ms=ta["blend_bwd_ms"], plain_ms=ta["blend_bwd_plain_ms"],
             bound_ms=ta["blend_bwd_bound_ms"], bound_by=ta["blend_bwd_bound_by"],
             library_ms=None, max_rel_err=errors["blend_bwd_rel"], tol=BWD_TOL,
             tol_of="row-relative", bound_counts="blended pairs",
             bound_evaluated_ms=ta["blend_bwd_work"]["bound_evaluated_ms"],
             feature_ms=tb["blend_bwd_ms"], feature_bound_ms=tb["blend_bwd_bound_ms"],
             feature_bound_by=tb["blend_bwd_bound_by"],
             feature_bound_evaluated_ms=tb["blend_bwd_work"]["bound_evaluated_ms"],
             cull_kept_share=[ta["cull_kept_share"], tb["cull_kept_share"]]),
        dict(name="segsum", route="cuda", source="langsplat_tpu_torch/csrc/segsum.cu",
             replaces="langsplat_tpu/ops/segsum_pallas.py:42",
             launches=launches["segsum"], max_abs_err=errors["segsum"],
             ms=ta["segsum_ms"], plain_ms=ta["segsum_plain_ms"],
             bound_ms=ta["segsum_bound_ms"], bound_by=ta["segsum_bound_by"],
             library_ms=ta["segsum_library_ms"], max_rel_err=errors["segsum_rel"],
             tol=SEG_TOL, tol_of="row-relative", feature_ms=tb["segsum_ms"],
             feature_bound_ms=tb["segsum_bound_ms"],
             feature_library_ms=tb["segsum_library_ms"]),
    ]
    log("training path launches: " + json.dumps(
        {ph: train_logs[ph]["launches"] for ph in train_logs}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
