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
     both grad modes, the segment sum with segments longer than 32 (the forward
     kernel, wherever it is compared, also twice with itself, bit for bit);
  3. the render path: a synthetic COLMAP scene (3 cameras at 1024x768) and a trained
     model of 1M Gaussians (sh_degree 3, 3 language-feature channels, made from
     --seed) written as PLY + npz checkpoint, rendered by
     `langsplat_tpu_torch.cli.render_cli.main` for RGB and --include_feature; the
     launch counters are zeroed just before and read just after; then the forward
     kernel is compared with its plain version on the path's own full-width inputs;
  4. render timings at full width, view 0: one whole `render_full` (host clock, ending
     in a synchronize), and with CUDA events preprocess, binning and the blend kernel,
     the plain version's time, the kernel's bound from this run's work, and the share
     of (instance, warp-region) pairs the blend kernels' cull keeps;
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
     the blend kernels' cull (one for the forward and the backward) keeps, counted with
     its plain mirror, which must keep every region the plain forward blends in;
  7. training timings at full width: per step (host clock, median of 5 after warm-up),
     its parts with CUDA events (forward render, loss, backward, optimizer), the
     device's idle share over 3 profiled steps, and the forward, backward and
     segment-sum kernels' times, plain times, bounds (each blend bound counts the
     blended pairs alone, with the count over every evaluated pair beside it), and the
     library segment sum as a yardstick;
  8. the autoencoder (no hand-written kernel on this path): a LERF-scale
     `language_features/` from --seed (200 images x 4 levels x 80 masks of unit 512-d
     rows, ~64k rows, with small segment maps) through
     `langsplat_tpu_torch.cli.autoencoder_cli` at the published widths (lr 7e-4, batch
     64) for 2 epochs with the best-checkpoint eval on, then its `test` CLI encoding
     every row into `language_features_dim3/`; the card's encode and decode on 4096 rows
     against the same checkpoint on the CPU (1e-5), TF32 off; ms per training step (CUDA
     events, median), epoch and encode times;
  9. the LERF eval: three feature levels rendered at 1024x768 by the render CLI from
     phase 3's field with its language features replaced per level (from --seed), a
     labelme GT of N_VIEWS frames with 8 prompts each (polygons of 20+ vertices), prompt
     embeddings from --seed and phase 8's checkpoint, through
     `langsplat_tpu_torch.cli.eval_cli --no_vis`; per frame the decode, relevancy,
     filter+IoU and localization ms, mIoU and localization accuracy; then frame 0's eval
     (`iou_loc.eval_frame`, the CLI's per-frame path) on the card and on the CPU: the
     [L, P, H, W] relevancy maps within 1e-5, the masks' flipped share, chosen levels
     and IoUs held as stated at EVAL_FLIP_TOL.
  10. the language-feature preprocessing (`process.sh` step 1, no hand-written kernel
     on this path) with stand-ins for SAM and CLIP (`StandInPredictor`,
     `StandInEncoder`; the CPU tests use the same definitions): PNG views painted from
     --seed, `pipeline.load_scene_images` (and a 1920x1440 view cut to 1440x1080, bit
     for bit against the CPU), `AutoMaskGenerator` with the preprocessing CLI's
     configuration and `pipeline.create` on the card into `language_features/`; per
     view the masks per level before and after `masks_update`, the NMS matrix's bytes,
     each stage's ms and the device's idle share; view 0 against the port on the CPU
     (records, tiles and seg maps equal, `_s.npy` bit-equal, `_f.npy` within one
     float16 unit); then the AE train and test CLIs on those files and phase B's
     loader (`Camera.get_language_feature`) on view 0; 10b: `transformers`' SAM at
     the sam-vit-huge widths and CLIP at the ViT-B/16 widths with random weights from
     --seed, loaded through the port's backends, one predictor call (64 points at
     1024x768) and 64 tiles encoded, timed.
  11. the rest of the single-device surface, on phase 5's scene and phase 3's field:
     (a) the train CLI with a torch.profiler trace window, phase A 10 steps (iterations
     6-8 traced) and phase B 4 steps from phase 5's checkpoint (iterations 2-3 traced,
     so neither window holds the last step's PLY save): the trace must hold K1, K2 and
     K3 launches in the counts the launch counters moved by inside the window; the ten
     device ops with the most time per step and the device's busy ms per step; (b)
     `training()` with the viewer bridge: a viewer thread holds iteration 1 for 3
     frames at 1024x768 through view 0's camera, then releases it; each frame
     byte-equal to the uint8 K1 render of the field that scene creation gives; ms per
     frame; (c) the native
     language-feature loader against numpy at 1024x768 (median of 10, bit-equal) and
     the prefetcher's wait in each of phase 5's phase-B steps, every load native; (d)
     view 0 of phase 3's field through the tiled backend (--interpret, at most 1024
     instances a tile) against K1 on every untruncated tile (2e-4), and the tiled
     backward on a small scene, bit-equal over two runs, through K3, within 5e-5 of
     the plain blend's gradients on the CPU; (e) the LPIPS arithmetic on AlexNet-shaped
     layer features of a 1024x768 pair, card against CPU (1e-6).
The launch counters are zeroed before, and read after, each path (phases 3, 5 A and B,
8, 9's render and eval, 10, 11a A and B, 11b, 11d's render and backward). The line
before the last is the `kernels` JSON; the last line is the result JSON.
It needs one CUDA card and imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# The cull's kept shares are counted on the same inputs by its plain mirror, not read
# from the kernels, which both take their masks from this one device routine
CULL_COUNTED_BY = "rasterize_cuda.warp_region_keep, mirror of blend_common.cuh stage_batch"
# Phase 8: a LERF-OVS scene's SAM table (~200 images, 4 mask levels, ~80 masks a level)
AE_IMAGES, AE_LEVELS, AE_MASKS = 200, 4, 80
AE_EPOCHS = 2               # of the published 100
AE_SEG_SHAPE = (48, 64)     # the copied segment maps, cut from image size (not read)
AE_TOL = 1e-5               # AE encode / decode, card against the CPU
# Phase 9
EVAL_PROMPTS = 8
REL_TOL = 1e-5              # relevancy maps, card against the CPU
# Card and CPU masks may differ where a normalized relevancy lies within rounding of the
# 0.4 threshold (or the mean filter's sums round apart): held to this share of the mask
# pixels, with each prompt's IoU within the same amount
EVAL_FLIP_TOL = 1e-3


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
    """Max abs error of the kernel against the plain version on the same inputs; raises
    unless a second launch gives the same image and final T bit for bit."""
    size = dict(image_height=h, image_width=w, tile_size=TILE)
    image, t_final = rasterize_cuda.blend_forward_cuda(*args, **size)
    again = rasterize_cuda.blend_forward_cuda(*args, **size)
    torch.cuda.synchronize()
    if not (torch.equal(image, again[0]) and torch.equal(t_final, again[1])):
        raise RuntimeError("blend_fwd gave different outputs in two launches")
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
        g, prep, inst = small_scene(n, w, h, seed, device)
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


def profile_render(fn, reps: int = 3, warmup: bool = True, host_events: bool = True
                   ) -> dict:
    """Device time by kernel over `reps` calls of `fn` (a render, a training step or a
    view's preprocessing; torch.profiler), after one call outside the window unless
    `warmup` is false, and the share of the window's wall time in which the device ran
    no kernel. Without `host_events` only the device is traced (a view's preprocessing
    makes ~10^5 host operator events, whose processing would cost more than the view)."""
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_events:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
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
    """The share of (instance, warp-region) pairs that the blend kernels' cull keeps
    (the forward's and the backward's are one), counted with its plain mirror on these
    inputs, beside the share that the plain forward blends; raises if the cull would
    skip a region an instance blends in."""
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
        raise RuntimeError(f"the blend kernels' cull skips {missed} (instance, "
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
        f"(tol {TOL:.0e}); bit-equal over two launches")
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
    log(f"phase 6 ({phase}): the blend kernels' cull keeps "
        f"{shares['cull_kept_share']:.4f} of the (instance, warp-region) pairs; the plain "
        f"forward blends in "
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
# Phases 8 and 9: the autoencoder and the eval
# ---------------------------------------------------------------------------

def zero_launches() -> None:
    for key in _build.LAUNCHES:
        _build.LAUNCHES[key] = 0


def write_ae_features(root: str, seed: int) -> int:
    """`<root>/language_features/<image>_{f,s}.npy` of a LERF-scale scene: per image,
    AE_LEVELS x AE_MASKS unit 512-d rows (CLIP-like: 64 scene-wide directions plus noise)
    and [4, *AE_SEG_SHAPE] segment maps. Returns the number of rows."""
    rng = np.random.default_rng(seed + 3)
    lf_dir = os.path.join(root, "language_features")
    os.makedirs(lf_dir)
    centers = rng.normal(size=(64, 512))
    rows = AE_LEVELS * AE_MASKS
    for i in range(AE_IMAGES):
        feats = centers[rng.integers(0, 64, rows)] + 0.5 * rng.normal(size=(rows, 512))
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        np.save(os.path.join(lf_dir, f"frame_{i:05d}_f.npy"), feats.astype(np.float32))
        seg = rng.integers(-1, AE_MASKS, (AE_LEVELS,) + AE_SEG_SHAPE).astype(np.int32)
        np.save(os.path.join(lf_dir, f"frame_{i:05d}_s.npy"), seg)
    return AE_IMAGES * rows


def autoencoder_phase(tmp: str, seed: int, device) -> dict:
    """Phase 8: the AE train and test CLIs at the published widths, checked and timed."""
    from langsplat_tpu_torch.cli import autoencoder_cli
    scene, ckpt_root = os.path.join(tmp, "ae_scene"), os.path.join(tmp, "ae_ckpt")
    t0 = time.perf_counter()
    rows = write_ae_features(scene, seed)
    log(f"phase 8: wrote {AE_IMAGES} images x {AE_LEVELS} levels x {AE_MASKS} masks = "
        f"{rows} unit 512-d rows in {time.perf_counter() - t0:.1f} s")
    log(f"phase 8 cut: epochs 100 -> {AE_EPOCHS} with --eval_from_frac 0 (the "
        f"best-checkpoint eval runs from epoch 1); segment maps {AE_SEG_SHAPE[1]}x"
        f"{AE_SEG_SHAPE[0]} (the test CLI copies them, nothing reads them); widths, "
        f"lr 7e-4 and batch 64 as published")
    common = ["--dataset_path", scene, "--dataset_name", "scene", "--ckpt_root", ckpt_root]
    zero_launches()
    t0 = time.perf_counter()
    train = autoencoder_cli.train_main(common + ["--num_epochs", str(AE_EPOCHS),
                                                 "--eval_from_frac", "0",
                                                 "--seed", str(seed)])
    test = autoencoder_cli.test_main(common)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    cli_s = time.perf_counter() - t0
    log(f"phase 8: AE train ({AE_EPOCHS} epochs x {train['steps_per_epoch']} steps) + "
        f"test CLIs in {cli_s:.1f} s; launches {launches} (no hand-written kernel on "
        f"this path); best epoch {train['best_epoch']}, best loss {train['best_loss']:.6f}")
    if not (train["best_epoch"] >= 1 and np.isfinite(train["best_loss"])):
        raise RuntimeError(f"the AE's best-checkpoint eval did not run: {train}")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("TF32 is on for float32 matmuls after the AE CLIs")

    # outputs, and the card against the CPU on the same checkpoint
    lf_dir, out_dir = (os.path.join(scene, d) for d in ("language_features",
                                                        "language_features_dim3"))
    data, counts = autoencoder_cli.load_feature_dataset(lf_dir)
    codes, out_counts = autoencoder_cli.load_feature_dataset(out_dir)
    same_maps = all(np.array_equal(np.load(os.path.join(lf_dir, f"{name[:-2]}_s.npy")),
                                   np.load(os.path.join(out_dir, f"{name[:-2]}_s.npy")))
                    for name in counts)
    if out_counts != counts or codes.shape != (rows, 3) or not np.isfinite(codes).all() \
            or not same_maps:
        raise RuntimeError("bad language_features_dim3 output")
    dims = ([256, 128, 64, 32, 3], [16, 32, 64, 128, 256, 256, 512])
    cpu_model = autoencoder_cli.load_ae_checkpoint(train["checkpoint"], *dims)
    gpu_model = autoencoder_cli.load_ae_checkpoint(train["checkpoint"], *dims).to(device)
    x = torch.from_numpy(data[:4096])
    with torch.no_grad():
        z_cpu = cpu_model.encode(x)
        enc_err = float((torch.from_numpy(codes[:4096]) - z_cpu).abs().max())
        enc_err = max(enc_err, float((gpu_model.encode(x.to(device)).cpu() - z_cpu)
                                     .abs().max()))
        dec_err = float((gpu_model.decode(z_cpu.to(device)).cpu() - cpu_model.decode(z_cpu))
                        .abs().max())
    norm_err = float(np.abs(np.linalg.norm(codes, axis=1) - 1).max())
    log(f"phase 8: card vs CPU on 4096 rows (the test CLI's codes and a fresh encode): "
        f"encode max_abs_err {enc_err:.3e}, decode {dec_err:.3e} (tol {AE_TOL:.0e}); "
        f"codes' |norm - 1| <= {norm_err:.1e}; TF32 off")
    if not (enc_err <= AE_TOL and dec_err <= AE_TOL and norm_err <= 1e-5):
        raise RuntimeError("the AE on the card disagrees with the CPU")

    # ms per training step: CUDA events around each of 60 steps, median of the last 50
    step = autoencoder_cli.TrainStep(gpu_model, 7e-4)
    batches = torch.from_numpy(data[np.arange(60 * 64) % len(data)]).to(device)
    batches = batches.reshape(60, 64, 512)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(60)]
    for (start, end), batch in zip(events, batches):
        start.record()
        step(batch)
        end.record()
    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in events][10:]
    timing = dict(rows=rows, steps_per_epoch=train["steps_per_epoch"],
                  step_ms=float(np.median(step_ms)), step_ms_min=float(np.min(step_ms)),
                  epoch_s=train["epoch_seconds"],
                  epoch_step_ms=[t / train["steps_per_epoch"] * 1e3
                                 for t in train["epoch_seconds"]],
                  encode_s=test["seconds"], cli_s=cli_s, launches=launches,
                  errors=dict(encode=enc_err, decode=dec_err))
    log("phase 8: " + json.dumps(timing))
    return dict(timing, checkpoint_root=ckpt_root, dims=dims)


def write_labelme_gt(root: str, seed: int, prompts: list[str]) -> None:
    """labelme GT of N_VIEWS frames (`frame_0000{i+1}.json` + `.jpg`), each with one
    polygon of 20-60 vertices per prompt (a star around a random centre, its points
    clipped to the image as labelme keeps them)."""
    from PIL import Image
    rng = np.random.default_rng(seed + 4)
    os.makedirs(root)
    for f in range(1, N_VIEWS + 1):
        objects = []
        for prompt in prompts:
            n = int(rng.integers(20, 61))
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            radius = rng.uniform(0.4, 1.0, (n, 1)) * rng.uniform(40, 250)
            centre = rng.uniform([0, 0], [WIDTH, HEIGHT])
            pts = np.clip(centre + radius * np.stack([np.cos(ang), np.sin(ang)], 1),
                          0, [WIDTH, HEIGHT])
            objects.append({"category": prompt,
                            "bbox": [*pts.min(axis=0).tolist(), *pts.max(axis=0).tolist()],
                            "segmentation": pts.tolist()})
        with open(os.path.join(root, f"frame_{f:05d}.json"), "w") as fh:
            json.dump({"info": {"height": HEIGHT, "width": WIDTH,
                                "name": f"frame_{f:05d}.jpg"}, "objects": objects}, fh)
        Image.fromarray(rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)).save(
            os.path.join(root, f"frame_{f:05d}.jpg"))


def eval_phase(tmp: str, seed: int, device, model_dir: str, scene_dir: str,
               ae: dict) -> dict:
    """Phase 9: feature levels through the render CLI, then the eval CLI on the card,
    then frame 0 on the card and on the CPU."""
    from langsplat_tpu_torch.cli.eval_cli import main as eval_main, make_decoder
    from langsplat_tpu_torch.cli.autoencoder_cli import load_ae_checkpoint
    from langsplat_tpu_torch.cli.render_cli import main as render_main
    from langsplat_tpu_torch.evaluation import iou_loc
    from langsplat_tpu_torch.evaluation.clip_text import PrecomputedTextEncoder
    from langsplat_tpu_torch.evaluation.relevancy import NEGATIVE_PROMPTS

    t0 = time.perf_counter()
    field = field_io.load_field(os.path.join(model_dir, "chkpnt1.npz"), device="cpu")[0]
    feat_root = os.path.join(tmp, "eval_out")
    level_dirs = []
    for lvl in (1, 2, 3):
        d = os.path.join(feat_root, f"scene_{lvl}")
        os.makedirs(os.path.join(d, "point_cloud"))
        os.symlink(os.path.join(model_dir, "point_cloud", "iteration_1"),
                   os.path.join(d, "point_cloud", "iteration_1"))
        lf = np.random.default_rng(seed + 10 + lvl).normal(size=(field.capacity, 3))
        field_io.save_field(os.path.join(d, "chkpnt1.npz"), dataclasses.replace(
            field, language_feature=torch.from_numpy(lf.astype(np.float32))), step=1,
            spatial_lr_scale=1.0, active_sh_degree=3)
        level_dirs.append(d)
    del field
    prompts = [f"prompt_{k}" for k in range(EVAL_PROMPTS)]
    label_root = os.path.join(tmp, "label")
    write_labelme_gt(os.path.join(label_root, "scene"), seed, prompts)
    rng = np.random.default_rng(seed + 5)
    text = os.path.join(tmp, "text_embeddings.npz")
    np.savez(text, **{p: rng.normal(size=512).astype(np.float32)
                      for p in prompts + list(NEGATIVE_PROMPTS)})
    log(f"phase 9: wrote 3 feature-level checkpoints, the labelme GT ({N_VIEWS} frames x "
        f"{EVAL_PROMPTS} prompts) and the prompt embeddings in "
        f"{time.perf_counter() - t0:.1f} s")

    zero_launches()
    t0 = time.perf_counter()
    for d in level_dirs:
        render_main(["-m", d, "-s", scene_dir, "--skip_test", "--include_feature"])
    torch.cuda.synchronize()
    render_launches = dict(_build.LAUNCHES)
    render_s = time.perf_counter() - t0
    log(f"phase 9: render CLI, 3 levels x {N_VIEWS} views of features in {render_s:.1f} s;"
        f" launches {render_launches}")
    if render_launches["blend_fwd"] < 3 * N_VIEWS:
        raise RuntimeError("the feature levels were not rendered through the blend kernel")

    zero_launches()
    t0 = time.perf_counter()
    result = eval_main(["--dataset_name", "scene", "--feat_dir", feat_root,
                        "--ae_ckpt_dir", ae["checkpoint_root"], "--json_folder", label_root,
                        "--text_embeddings", text, "--iteration", "1", "--no_vis",
                        "--output_dir", os.path.join(tmp, "eval_result")])
    torch.cuda.synchronize()
    eval_launches = dict(_build.LAUNCHES)
    eval_s = time.perf_counter() - t0
    for fr in result["frames"]:
        log(f"phase 9: frame {fr['idx']}: decode {fr['decode_ms']:.1f} ms, relevancy "
            f"{fr['relevancy_ms']:.1f} ms, filter+IoU {fr['filter_iou_ms']:.1f} ms, "
            f"localization {fr['localization_ms']:.1f} ms (host clock, each ending in a "
            f"synchronize); levels {fr['levels']}")
    log(f"phase 9: eval CLI on the card in {eval_s:.1f} s (GT parsing and file reads "
        f"included); mIoU {result['miou']:.4f}, localization accuracy "
        f"{result['localization_acc']:.4f}; launches {eval_launches} (no hand-written "
        f"kernel on this path)")
    if len(result["frames"]) != N_VIEWS or not np.isfinite(result["miou"]):
        raise RuntimeError(f"bad eval result: {result}")

    # frame 0, the CLI's per-frame path, on the card and on the CPU
    feat_dirs = [os.path.join(d, "train", "ours_1", "renders_npy") for d in level_dirs]
    sem_feat = iou_loc.load_frame_features(feat_dirs, 0)
    img_ann = iou_loc.eval_gt_lerfdata(os.path.join(label_root, "scene"))[0]["0"]
    encoder = PrecomputedTextEncoder(text)
    pos, neg = encoder(list(img_ann)), encoder(list(NEGATIVE_PROMPTS))
    ckpt = os.path.join(ae["checkpoint_root"], "scene", "best_ckpt.npz")
    runs = []
    for dev in (device, torch.device("cpu")):
        model = load_ae_checkpoint(ckpt, *ae["dims"]).to(dev)
        t0 = time.perf_counter()
        fr = iou_loc.eval_frame(sem_feat, img_ann, make_decoder(model), pos, neg, dev)
        fr["seconds"] = time.perf_counter() - t0
        runs.append({k: v.cpu() if torch.is_tensor(v) else v for k, v in fr.items()})
    gpu, cpu = runs
    rel_err = float((gpu["valid_map"] - cpu["valid_map"]).abs().max())
    flipped = float((gpu["masks"] != cpu["masks"]).float().mean())
    top2 = torch.topk(cpu["score"], 2, dim=0).values
    clear = (top2[0] - top2[1]) > REL_TOL      # prompts whose best level is no near-tie
    level_ok = all(a == b or not bool(c) for a, b, c in zip(gpu["levels"], cpu["levels"],
                                                            clear))
    iou_err = max(abs(a - b) for a, b in zip(gpu["ious"], cpu["ious"]))
    log(f"phase 9: frame 0 on the card vs the CPU ({cpu['seconds']:.1f} s there): "
        f"relevancy maps [L, P, H, W] = {list(gpu['valid_map'].shape)} max_abs_err "
        f"{rel_err:.3e} (tol {REL_TOL:.0e}); masks flipped {flipped:.2e} of the pixels "
        f"(tol {EVAL_FLIP_TOL:.0e}); chosen levels {gpu['levels']} vs {cpu['levels']} "
        f"({int(clear.sum())} of {len(clear)} prompts without a near-tie); IoUs within "
        f"{iou_err:.2e}; localization {gpu['acc']} vs {cpu['acc']}")
    if not (rel_err <= REL_TOL and flipped <= EVAL_FLIP_TOL and level_ok
            and iou_err <= EVAL_FLIP_TOL):
        raise RuntimeError("the eval on the card disagrees with the CPU")
    return dict(frames=result["frames"],
                miou=result["miou"], localization_acc=result["localization_acc"],
                eval_s=eval_s, render_s=render_s, render_launches=render_launches,
                eval_launches=eval_launches, relevancy_err=rel_err, flipped=flipped,
                iou_err=iou_err, frame0_cpu_s=cpu["seconds"])


# ---------------------------------------------------------------------------
# Phase 10: the language-feature preprocessing, with stand-ins for SAM and CLIP
# ---------------------------------------------------------------------------

PRE_VIEWS = 3               # 1024x768 views through the generator
PRE_BIG = (1920, 1440)      # one more view that load_scene_images cuts to 1440x1080
PRE_CELLS = (12, 10)        # the scene's jittered grid: one object in ~90% of the cells


def paint_scene(seed: int, width: int, height: int, cells=PRE_CELLS) -> np.ndarray:
    """[H, W, 3] uint8 RGB: an ellipse in ~90% of the cells of a jittered grid, each cut
    into 2-4 sectors (parts); R is the object id (1..), G is 40 x the part (1..4), B
    the group (the 2x2 block of cells the object lies in), (0, 0, 0) the background. A
    seeded 30% of the objects carry a hole and an island of ~28 px (under the 100 px of
    `remove_small_regions`)."""
    rng = np.random.default_rng(seed)
    nx, ny = cells
    cell_w, cell_h = width / nx, height / ny
    img = np.zeros((height, width, 3), np.uint8)
    obj = 0
    for j in range(ny):
        for i in range(nx):
            if rng.random() < 0.1:
                continue
            obj += 1
            cx = (i + rng.uniform(0.35, 0.65)) * cell_w
            cy = (j + rng.uniform(0.35, 0.65)) * cell_h
            a, b = rng.uniform(0.25, 0.45) * cell_w, rng.uniform(0.25, 0.45) * cell_h
            th = rng.uniform(0, math.pi)
            n_parts = int(rng.integers(2, 5))
            group = (j // 2) * ((nx + 1) // 2) + i // 2 + 1
            r = int(max(a, b)) + 8
            y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, height)
            x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, width)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            dx, dy = xx - cx, yy - cy
            u = (dx * math.cos(th) + dy * math.sin(th)) / a
            v = (-dx * math.sin(th) + dy * math.cos(th)) / b
            inside = u * u + v * v < 1
            part = np.minimum((np.arctan2(v, u) + math.pi) / (2 * math.pi) * n_parts,
                              n_parts - 1).astype(np.int64) + 1
            colour = np.stack([np.full(part.shape, obj), 40 * part,
                               np.full(part.shape, group)], -1)
            win = img[y0:y1, x0:x1]
            win[inside] = colour[inside]
            if rng.random() < 0.3:
                hx, hy = cx + 0.5 * a * math.cos(th), cy + 0.5 * a * math.sin(th)
                win[(xx - hx) ** 2 + (yy - hy) ** 2 < 9] = 0
                ix, iy = cx - (a + 5) * math.cos(th), cy - (a + 5) * math.sin(th)
                win[((xx - ix) ** 2 + (yy - iy) ** 2 < 9) & ~inside] = (obj, 40, group)
    return img


class StandInPredictor:
    """SAM stand-in for `paint_scene` images, a pure function of (crop, points) on
    `device`: per point, the part, object and group masks under it as the three heads
    (empty on the background). The logits are (2k - 25) / d, k the mask's pixel count
    in the 5x5 window around a pixel and d in 3..15 per object: a soft band at the
    edges, so the stability score varies by mask, and the same bits on any device. The
    IoU predictions come from a seeded table in [0.6, 1) per object."""

    def __init__(self, seed: int, device):
        rng = np.random.default_rng(seed + 10)
        self.device = torch.device(device)
        self.iou = torch.as_tensor(rng.uniform(0.6, 1.0, (256, 3)).astype(np.float32),
                                   device=self.device)
        self.div = torch.as_tensor(rng.integers(3, 16, 256).astype(np.float32),
                                   device=self.device)

    def __call__(self, crop, points):
        dev = self.device
        img = torch.as_tensor(np.ascontiguousarray(crop), device=dev).long()
        h, w = img.shape[:2]
        obj = img[..., 0]
        keys = torch.stack([obj * 5 + img[..., 1] // 40, obj, img[..., 2]]) * (obj > 0)
        pts = torch.as_tensor(np.asarray(points), device=dev)
        px = pts[:, 0].long().clamp(0, w - 1)
        py = pts[:, 1].long().clamp(0, h - 1)
        key = keys[:, py, px].T                                  # [P, 3]
        n = len(key)
        # k inside a window around each mask's bounding box (+2 px), 0 outside it
        flat = keys.flatten(1)
        table = torch.zeros((3, int(keys.max()) + 1), dtype=torch.long, device=dev)

        def extent(v, reduce, init):
            return table.fill_(init).scatter_reduce(1, flat, v.expand(3, -1),
                                                    reduce).gather(1, key.T).T
        ys = torch.arange(h, device=dev).repeat_interleave(w)
        xs = torch.arange(w, device=dev).repeat(h)
        y0, y1 = extent(ys, "amin", h), extent(ys, "amax", -1)
        x0, x1 = extent(xs, "amin", w), extent(xs, "amax", -1)
        on = key > 0                          # the background's mask is empty
        win_h = min(int(torch.where(on, y1 - y0, 0).max()) + 5, h)
        win_w = min(int(torch.where(on, x1 - x0, 0).max()) + 5, w)
        oy = (y0 - 2).clamp(min=0).clamp(max=h - win_h)
        ox = (x0 - 2).clamp(min=0).clamp(max=w - win_w)
        rows = (oy[..., None] + torch.arange(win_h, device=dev))[..., :, None]
        cols = (ox[..., None] + torch.arange(win_w, device=dev))[..., None, :]
        heads = torch.arange(3, device=dev)[None, :, None, None]
        win = (keys[heads, rows, cols] == key[:, :, None, None]) & on[:, :, None, None]
        # the 5x5 box count, in integers
        c = torch.nn.functional.pad(win.int(), (3, 2, 3, 2)).cumsum(3)
        c = (c[..., 5:] - c[..., :-5]).cumsum(2)
        k = c[:, :, 5:] - c[:, :, :-5]
        d = self.div[key[:, 1]][:, None, None, None]
        logits = (torch.full((n, 3, 1, 1), -25.0, device=dev) / d).expand(
            n, 3, h, w).contiguous()
        pi = torch.arange(n, device=dev)[:, None, None, None]
        logits[pi, heads, rows, cols] = (2 * k - 25) / d
        return logits > 0, self.iou[key[:, 1]], logits


class StandInEncoder:
    """CLIP image encoder stand-in: the tiles [M, 3, 224, 224] pooled to 3 x 8 x 8 and
    projected to 512 dimensions by a seeded fixed matrix, on `device`."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(seed + 20)
        self.proj = torch.randn((3 * 8 * 8, 512), generator=gen).to(self.device)

    def __call__(self, tiles) -> torch.Tensor:
        import torch.nn.functional as F
        t = torch.as_tensor(tiles, dtype=torch.float32, device=self.device)
        return F.avg_pool2d(t, 28).flatten(1) @ self.proj


class StageTimer:
    """Wraps callables so that each call adds its wall time, between two device
    synchronizes, to a named stage (with `events`, CUDA events around the call
    instead); `restore` puts back the attributes that `wrap` replaced."""

    def __init__(self):
        self.ms, self._undo = {}, []

    def timed(self, fn, stage: str, events: bool = False):
        def call(*args, **kwargs):
            if events:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            self.ms[stage] = self.ms.get(stage, 0.0) + ms
            return out
        return call

    def wrap(self, owner, name: str, stage: str, events: bool = False) -> None:
        fn = getattr(owner, name)
        setattr(owner, name, self.timed(fn, stage, events))
        self._undo.append((owner, name, fn))

    def restore(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo.clear()


class Recorder:
    """Keeps the outputs of wrapped callables per name until `restore`."""

    def __init__(self):
        self.out, self._undo = {}, []

    def wrap(self, owner, name: str) -> None:
        fn = getattr(owner, name)
        sink = self.out.setdefault(name, [])

        def call(*args, **kwargs):
            res = fn(*args, **kwargs)
            sink.append(res)
            return res
        setattr(owner, name, call)
        self._undo.append((owner, name, fn))

    def restore(self) -> None:
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo.clear()


def write_pre_scene(root: str, seed: int, views: int, size) -> None:
    from PIL import Image
    os.makedirs(os.path.join(root, "images"))
    for v in range(views):
        Image.fromarray(paint_scene(seed + 100 + v, *size, PRE_CELLS)).save(
            os.path.join(root, "images", f"view_{v:03d}.png"))


def same_records(a: list, b: list) -> bool:
    """The generator's records equal, in order: masks, boxes, scores, points, crops."""
    return len(a) == len(b) and all(
        torch.equal(ra["segmentation"].cpu(), rb["segmentation"].cpu())
        and np.array_equal(ra["bbox"], rb["bbox"])
        and ra["predicted_iou"] == rb["predicted_iou"]
        and ra["stability_score"] == rb["stability_score"]
        and ra["point_coords"] == rb["point_coords"] and ra["crop_box"] == rb["crop_box"]
        for ra, rb in zip(a, b))


def recorded_create(name, image, out_dir, generator, encoder, timer=None) -> dict:
    """`pipeline.create` of one view, keeping the generator's records, the levels
    after `masks_update` and every (tiles, seg map); with `timer`, its stages timed."""
    from langsplat_tpu_torch.preprocess import auto_mask, masks as pmasks, pipeline
    rec = Recorder()
    rec.wrap(generator, "generate")
    rec.wrap(pipeline, "masks_update")
    rec.wrap(pipeline, "mask_to_segmap")
    labelled = [0]
    remove = generator._remove_small_regions

    def counted(segs):
        labelled[0] += len(segs)
        return remove(segs)
    generator._remove_small_regions = counted
    if timer is not None:
        timer.wrap(generator, "predictor", "predictor")
        timer.wrap(generator, "_filter_batch", "filters")
        timer.wrap(generator, "_remove_small_regions", "remove_small_regions")
        timer.wrap(auto_mask, "box_nms", "box_nms")
        timer.wrap(pmasks, "mask_nms_matrices", "mask_nms_product", events=True)
        timer.wrap(pipeline, "mask_to_segmap", "tiles")
        timer.wrap(pipeline, "write_features", "file_writes")
        encoder = timer.timed(encoder, "encoder")
    t0 = time.perf_counter()
    try:
        pipeline.create([image], [name], out_dir, generator, encoder)
        if generator.device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        if timer is not None:
            timer.restore()
        generator._remove_small_regions = remove
        rec.restore()
    return dict(seconds=time.perf_counter() - t0, records=rec.out["generate"][0],
                updated=rec.out["masks_update"][0], segmaps=rec.out["mask_to_segmap"],
                labelled=labelled[0])


def float16_units(a: np.ndarray, b: np.ndarray) -> float:
    """Largest |a - b| of two float16 arrays in units of the float16 spacing at the
    larger magnitude."""
    a, b = a.astype(np.float32), b.astype(np.float32)
    unit = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16)).astype(np.float32)
    return float((np.abs(a - b) / unit).max()) if a.size else 0.0


def preprocess_phase(tmp: str, seed: int, device) -> dict:
    """Phase 10: `process.sh` step 1 through the port (load_scene_images, the CLI's
    AutoMaskGenerator, create) on the card with the stand-ins, checked against the port
    on the CPU on view 0, then the AE CLIs and phase B's loader on its files."""
    from langsplat_tpu_torch.cli import autoencoder_cli
    from langsplat_tpu_torch.cli.preprocess_cli import auto_mask_config
    from langsplat_tpu_torch.data.cameras import Camera
    from langsplat_tpu_torch.preprocess import pipeline
    from langsplat_tpu_torch.preprocess.auto_mask import AutoMaskGenerator

    scene, big = os.path.join(tmp, "pre_scene"), os.path.join(tmp, "pre_big")
    t0 = time.perf_counter()
    write_pre_scene(scene, seed, PRE_VIEWS, (WIDTH, HEIGHT))
    write_pre_scene(big, seed + 50, 1, PRE_BIG)
    log(f"phase 10: wrote {PRE_VIEWS} PNG views at {WIDTH}x{HEIGHT} and one at "
        f"{PRE_BIG[0]}x{PRE_BIG[1]} ({PRE_CELLS[0]}x{PRE_CELLS[1]} cells, objects of 2-4 "
        f"parts in 2x2-cell groups) in {time.perf_counter() - t0:.1f} s")

    # the downscale to 1080 rows, on the card against the CPU
    down_ms = host_ms(lambda: pipeline.load_scene_images(big, device=device), reps=1)
    big_card = pipeline.load_scene_images(big, device=device)[0][0]
    big_cpu = pipeline.load_scene_images(big, device="cpu")[0][0]
    down_equal = bool(np.array_equal(big_card, big_cpu))
    log(f"phase 10: load_scene_images of the {PRE_BIG[0]}x{PRE_BIG[1]} PNG -> "
        f"{big_card.shape[1]}x{big_card.shape[0]} in {down_ms:.1f} ms (PIL decode, the "
        f"resize on the card); bit-equal to the CPU: {down_equal}")
    if big_card.shape != (1080, PRE_BIG[0] * 1080 // PRE_BIG[1], 3) or not down_equal:
        raise RuntimeError("the downscale to 1080 rows disagrees with the CPU")

    t0 = time.perf_counter()
    images, names = pipeline.load_scene_images(scene, device=device)
    load_ms = (time.perf_counter() - t0) * 1e3
    generator = AutoMaskGenerator(StandInPredictor(seed, device), auto_mask_config(),
                                  device=device)
    encoder = StandInEncoder(seed, device)
    lf_dir = os.path.join(scene, "language_features")

    # the main path: every view through create, its stages timed
    zero_launches()
    t0 = time.perf_counter()
    views, card = [], None
    for name, image in zip(names, images):
        timer = StageTimer()
        run = recorded_create(name, image, lf_dir, generator, encoder, timer)
        before = [len(r) for r in run["records"]]
        views.append(dict(
            view=name, ms=run["seconds"] * 1e3, masks_labelled=run["labelled"],
            masks_per_level_before=before,
            masks_per_level_after=[len(r) for r in run["updated"]],
            nms_matrix_bytes=[m * image.shape[0] * image.shape[1] * 4 for m in before],
            stage_ms=timer.ms))
        card = card or run
    launches = dict(_build.LAUNCHES)
    create_s = time.perf_counter() - t0
    if launches != {k: 0 for k in launches}:
        raise RuntimeError(f"a blend or segment-sum kernel ran on this path: {launches}")
    # the device's idle share over each view: create again under torch.profiler
    t0 = time.perf_counter()
    prof_dir = os.path.join(tmp, "pre_profiled")
    for view, name, image in zip(views, names, images):
        prof = profile_render(lambda: pipeline.create([image], [name], prof_dir, generator,
                                                      encoder), reps=1, warmup=False,
                              host_events=False)
        view.update(profiled_ms=prof["wall_ms_per_call"],
                    device_ms=prof["device_ms_per_call"],
                    device_idle_share=prof["device_idle_share"])
        log(f"phase 10: {json.dumps(view)}")
    profiled_s = time.perf_counter() - t0
    log(f"phase 10: create on the card, {PRE_VIEWS} views in {create_s:.1f} s with the "
        f"stage timers, again in {profiled_s:.1f} s under torch.profiler; launches "
        f"{launches} (no hand-written kernel on this path)")
    t0 = time.perf_counter()

    # view 0: the card against the port on the CPU (the stand-ins give the same bits
    # on both)
    cpu_gen = AutoMaskGenerator(StandInPredictor(seed, "cpu"), auto_mask_config(),
                                device="cpu")
    cpu_dir = os.path.join(tmp, "pre_cpu")
    cpu = recorded_create(names[0], images[0], cpu_dir, cpu_gen, StandInEncoder(seed, "cpu"))
    records_equal = all(same_records(a, b) for a, b in zip(card["records"], cpu["records"]))
    tiles_equal = len(card["segmaps"]) == len(cpu["segmaps"]) and all(
        torch.equal(a.cpu(), b) and torch.equal(sa.cpu(), sb)
        for (a, sa), (b, sb) in zip(card["segmaps"], cpu["segmaps"]))
    base = os.path.splitext(names[0])[0]
    s_equal = np.array_equal(np.load(os.path.join(lf_dir, base + "_s.npy")),
                             np.load(os.path.join(cpu_dir, base + "_s.npy")))
    f_card = np.load(os.path.join(lf_dir, base + "_f.npy"))
    f_cpu = np.load(os.path.join(cpu_dir, base + "_f.npy"))
    f_units = float16_units(f_card, f_cpu) if f_card.shape == f_cpu.shape else math.inf
    cpu_s = cpu["seconds"]
    check_s = time.perf_counter() - t0
    log(f"phase 10: view 0 on the card vs the CPU ({cpu_s:.1f} s there, {check_s:.1f} s "
        f"with the comparisons): "
        f"records equal {records_equal} ({[len(r) for r in cpu['records']]} per level), "
        f"tiles and seg maps bit-equal {tiles_equal}, _s.npy bit-equal {s_equal}, _f.npy "
        f"{list(f_card.shape)} within {f_units:.1f} float16 units (tol 1)")
    if not (records_equal and tiles_equal and s_equal and f_units <= 1):
        raise RuntimeError("the preprocessing on the card disagrees with the CPU")
    del card, cpu

    # the files through the AE CLIs and phase B's loader
    common = ["--dataset_path", scene, "--dataset_name", "pre", "--ckpt_root",
              os.path.join(tmp, "pre_ckpt")]
    t0 = time.perf_counter()
    train = autoencoder_cli.train_main(common + ["--num_epochs", "1", "--eval_from_frac",
                                                 "0", "--seed", str(seed)])
    autoencoder_cli.test_main(common)
    ae_s = time.perf_counter() - t0
    cam = Camera(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3), fov_x=FOV_X,
                 fov_y=FOV_X * HEIGHT / WIDTH, image=None, image_name=base, width=WIDTH,
                 height=HEIGHT)
    feat, mask = cam.get_language_feature(os.path.join(scene, "language_features_dim3"), 1)
    covered = float(mask.mean())
    log(f"phase 10: AE train (1 epoch, {train['steps_per_epoch']} steps) + test CLIs on "
        f"the {f_card.shape[0]}-row view-0 table and the others in {ae_s:.1f} s; phase B's "
        f"loader on view 0, level 1: features {list(feat.shape)}, {covered:.3f} of the "
        f"pixels covered")
    if feat.shape != (3, HEIGHT, WIDTH) or not np.isfinite(feat).all() or covered <= 0:
        raise RuntimeError("phase B's loader did not read the preprocessing's files")
    return dict(views=views, load_ms=load_ms, create_s=create_s, profiled_s=profiled_s,
                down_ms=down_ms, cpu_view0_s=cpu_s, check_s=check_s, f_units=f_units,
                ae_s=ae_s, level1_covered=covered)


# Phase 10b: SAM ViT-H and CLIP ViT-B/16 at their published widths, random weights
SAM_VIT_HUGE = dict(hidden_size=1280, num_hidden_layers=32, num_attention_heads=16,
                    mlp_dim=5120, global_attn_indexes=[7, 15, 23, 31], window_size=14,
                    patch_size=16, image_size=1024, output_channels=256)
CLIP_VIT_B16 = dict(
    text_config=dict(hidden_size=512, intermediate_size=2048, num_hidden_layers=12,
                     num_attention_heads=8),
    vision_config=dict(hidden_size=768, intermediate_size=3072, num_hidden_layers=12,
                       num_attention_heads=12, patch_size=16, image_size=224),
    projection_dim=512)


def published_widths_phase(tmp: str, seed: int, device) -> dict:
    """Phase 10b: `transformers`' SamModel at the sam-vit-huge widths and CLIPModel at
    the ViT-B/16 widths, random weights from --seed, written to a local directory and
    loaded through the port's backends; one predictor call (64 points on a 1024x768
    view) and the encoding of 64 tiles, timed. With random weights the masks and
    embeddings mean nothing: only shapes, finiteness and times are read."""
    os.environ.setdefault("HF_HUB_OFFLINE", "1")      # local directories only
    import transformers
    from langsplat_tpu_torch.preprocess.auto_mask import build_point_grid
    from langsplat_tpu_torch.preprocess.backends import (TransformersClipImageEncoder,
                                                         TransformersSamPredictor)

    t0 = time.perf_counter()
    sam_dir, clip_dir = os.path.join(tmp, "sam_vit_huge"), os.path.join(tmp, "clip_b16")
    torch.manual_seed(seed)
    with torch.device(device):
        model = transformers.SamModel(transformers.SamConfig(vision_config=SAM_VIT_HUGE))
        sam_params = sum(p.numel() for p in model.parameters())
        model.save_pretrained(sam_dir)
        del model
        model = transformers.CLIPModel(transformers.CLIPConfig(**CLIP_VIT_B16))
        clip_params = sum(p.numel() for p in model.parameters())
        model.save_pretrained(clip_dir)
        del model
    transformers.SamProcessor(transformers.SamImageProcessor()).save_pretrained(sam_dir)
    predictor = TransformersSamPredictor(sam_dir, device=device)
    encoder = TransformersClipImageEncoder(clip_dir, device=device)
    setup_s = time.perf_counter() - t0

    image = paint_scene(seed + 7, WIDTH, HEIGHT)
    points = build_point_grid(32)[:64] * np.array([WIDTH, HEIGHT])
    masks, ious, logits = predictor(image, points)
    predictor_ms = host_ms(lambda: predictor(image, points), reps=3)
    tiles = torch.rand((64, 3, 224, 224), device=device,
                       generator=torch.Generator(device).manual_seed(seed))
    embeds = encoder(tiles)
    encoder_ms = cuda_ms(lambda: encoder(tiles), reps=5)
    ok = (masks.shape == (64, 3, HEIGHT, WIDTH) and tuple(ious.shape) == (64, 3)
          and bool(torch.isfinite(logits).all()) and tuple(embeds.shape) == (64, 512)
          and bool(torch.isfinite(embeds).all()))
    result = dict(sam_params=sam_params, clip_params=clip_params, setup_s=setup_s,
                  predictor_ms=predictor_ms, encoder_64_tiles_ms=encoder_ms,
                  transformers=transformers.__version__)
    log(f"phase 10b: SamModel at sam-vit-huge widths ({sam_params / 1e6:.0f}M parameters) "
        f"and CLIPModel at ViT-B/16 widths ({clip_params / 1e6:.0f}M), random weights, "
        f"written and loaded through the port's backends in {setup_s:.1f} s "
        f"(transformers {transformers.__version__}); one predictor call (64 points, "
        f"{WIDTH}x{HEIGHT}, SAM's image encoder included, host clock) {predictor_ms:.1f} "
        f"ms; 64 tiles through the CLIP image encoder {encoder_ms:.2f} ms (CUDA events); "
        f"outputs of the expected shapes and finite: {ok} (random weights: the masks and "
        f"embeddings mean nothing)")
    if not ok:
        raise RuntimeError("the transformers backends gave outputs of the wrong shape")
    return result


# ---------------------------------------------------------------------------
# Phase 11: the rest of the single-device surface: the profiler trace window, the
# viewer bridge, the native feature loader, the tiled backend, the LPIPS arithmetic
# ---------------------------------------------------------------------------

# trace windows of the train CLI: phase A 10 steps (of 30,000), iterations 6-8 traced;
# phase B 4 steps, iterations 2-3 traced. Each window closes before the last step, whose
# PLY save (the CLI always saves the last iteration) would otherwise fill the trace.
TRACE_RUNS = {"A": dict(steps=10, first=6, window=3, traced=(6, 9)),
              "B": dict(steps=4, first=2, window=2, traced=(2, 4))}
# the hand-written kernels' symbols in a trace
KERNEL_SYMBOLS = {"blend_fwd": "blend_fwd_kernel", "blend_bwd": "blend_bwd_kernel",
                  "segsum": "segsum_kernel"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GUI_FRAMES = 3              # frames the viewer holds iteration 1 for, then it releases
LOADER_REPS = 10
MAX_PER_TILE = 1024
TILED_TOL = 2e-4            # the tiled image against K1's, on untruncated tiles
TILED_GRAD_TOL = 5e-5       # the tiled backward on the card against the plain one (CPU)
LPIPS_TOL = 1e-6            # the LPIPS arithmetic, card against the CPU
# AlexNet's LPIPS layers (relu1 .. relu5) for a 1024x768 input: channels, height, width
ALEX_LAYERS = ((64, 191, 255), (192, 95, 127), (384, 47, 63), (256, 47, 63),
               (256, 47, 63))


def read_trace(trace: dict) -> dict:
    """The device side of a training trace window (`training`'s trace record): each
    hand-written kernel's launches in the trace, the ten device ops with the most time
    per step, and the device's busy ms per step (the union of its ops' intervals)."""
    with open(trace["path"]) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not events:
        raise RuntimeError(f"the trace {trace['path']} holds no device op")
    steps = trace["iterations"][1] - trace["iterations"][0]
    in_trace = {k: sum(1 for e in events if sym in e["name"])
                for k, sym in KERNEL_SYMBOLS.items()}
    totals: dict[str, list] = {}
    for e in events:
        acc = totals.setdefault(e["name"][:100], [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:10]
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return dict(steps=steps, device_ops=len(events), launches_in_trace=in_trace,
                device_busy_ms_per_step=busy / steps / 1e3,
                top_device_ops=[dict(name=n, ms_per_step=t / steps / 1e3,
                                     calls_per_step=c / steps) for n, (t, c) in top])


def trace_phase(tmp: str, train_scene: str, run_prefix: str) -> dict:
    """11a: the train CLI with a trace window, phase A from the SfM points and phase B
    from phase 5's phase-A checkpoint; the trace must hold each kernel's launches in the
    counts the launch counters moved by inside the window."""
    from langsplat_tpu_torch.cli.train_cli import main as train_main
    checkpoint = os.path.join(run_prefix + "_-1", f"chkpnt{TRAIN_STEPS}.npz")
    phase_flags = {"A": ["--no_include_feature"],
                   "B": ["--feature_level", "1", "--start_checkpoint", checkpoint]}
    out = {}
    for name, run in TRACE_RUNS.items():
        zero_launches()
        t0 = time.perf_counter()
        result = train_main(
            ["-s", train_scene, "-m", os.path.join(tmp, f"trace_run_{name}"), "--quiet",
             "--iterations", str(run["steps"]), "--sh_degree", "3", *BUDGET_FLAGS,
             "--test_iterations", "999999", "--checkpoint_iterations", "999999",
             "--profile_dir", os.path.join(tmp, f"trace_{name}"),
             "--profile_from", str(run["first"]), "--profile_steps", str(run["window"]),
             *phase_flags[name]])
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        seconds = time.perf_counter() - t0
        history, trace = result["history"], result["trace"]
        if len(history) != run["steps"] or not np.all(np.isfinite(history)):
            raise RuntimeError(f"11a ({name}): bad loss history {history}")
        if trace is None or tuple(trace["iterations"]) != run["traced"]:
            raise RuntimeError(f"11a ({name}): expected a trace of iterations "
                               f"{run['traced']}, got {trace}")
        device = read_trace(trace)
        counted = trace["launches"]
        if device["launches_in_trace"] != counted or min(counted.values()) < 1:
            raise RuntimeError(f"11a ({name}): kernel launches in the trace "
                               f"{device['launches_in_trace']}, counted in the window "
                               f"{counted}")
        out[name] = dict(seconds=seconds, launches=launches, window_launches=counted,
                         trace_mb=os.path.getsize(trace["path"]) / 2**20, **device)
        log(f"phase 11a ({name}): {run['steps']} steps in {seconds:.1f} s; trace of "
            f"iterations {trace['iterations']} holds the window's launches {counted}; "
            + json.dumps(out[name]))
    return out


def gui_phase(train_scene: str, seed: int, device) -> dict:
    """11b: `training()` with the viewer bridge on phase 5's scene: a viewer holds
    iteration 1 for GUI_FRAMES frames at 1024x768 through view 0's camera, then releases
    it; every frame must be byte-equal to the uint8 render, through K1, of the field that
    scene creation gives."""
    import socket
    import threading
    from langsplat_tpu_torch.config import ModelConfig, TrainConfig
    from langsplat_tpu_torch.data.scene import Scene
    from langsplat_tpu_torch.ops.render import RenderSettings
    from langsplat_tpu_torch.train import loop
    from langsplat_tpu_torch.utils import network_gui

    mcfg = ModelConfig(source_path=train_scene, sh_degree=3)
    pipe = PipelineConfig(budget_factor=int(BUDGET_FLAGS[1]))
    ocfg = OptimizationConfig(iterations=1, include_feature=False)
    cfg = TrainConfig(model=mcfg, pipeline=pipe, optimization=ocfg, test_iterations=(),
                      save_iterations=(), checkpoint_iterations=(), seed=seed, quiet=True)
    cam = load_camera(read_colmap_scene(train_scene).train_cameras[0], 1.0, -1, uid=0)
    # the viewer sends the matrices with the Y/Z columns negated (receive flips back)
    view = cam.world_view_transform.astype(np.float64)
    proj = cam.full_proj_transform.astype(np.float64)
    view[:, 1:3] *= -1.0
    proj[:, 1] *= -1.0

    def packet(train: bool, width: int = WIDTH, height: int = HEIGHT) -> bytes:
        return network_gui.viewer_packet(width, height, cam.fov_x, cam.fov_y, view, proj,
                                         train=train, keep_alive=False)

    # the reference: the created field, rendered as the loop's poll renders it
    t0 = time.perf_counter()
    created = Scene(mcfg, device=device, seed=seed,
                    initial_capacity_factor=ocfg.initial_capacity_factor).gaussians
    minicam = network_gui.MiniCam(WIDTH, HEIGHT, cam.fov_y, cam.fov_x, 0.01, 100.0,
                                  cam.world_view_transform, cam.full_proj_transform)
    settings = RenderSettings(image_height=HEIGHT, image_width=WIDTH,
                              tanfovx=minicam.tanfovx, tanfovy=minicam.tanfovy,
                              sh_degree=0, include_feature=False, tile_size=TILE,
                              budget=pipe.budget_factor * created.capacity)
    with torch.no_grad():
        want = bytes(network_gui.frame_bytes(render(
            created, settings, *loop._camera_tensors(minicam, device),
            torch.zeros(3, device=device))["render"]))
    del created
    ref_s = time.perf_counter() - t0

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    frames, frame_ms, errors = [], [], []

    def viewer():
        try:
            with network_gui.ViewerClient("127.0.0.1", port, timeout=120) as conn:
                # a zero resolution asks for no frame: the reply (the verify string
                # alone) says the loop is polling, so the frames' clocks start there
                conn.request(packet(False, 0, 0), 0, 0)
                for train in [False] * GUI_FRAMES + [True]:
                    t = time.perf_counter()
                    frames.append(conn.request(packet(train), WIDTH, HEIGHT))
                    frame_ms.append((time.perf_counter() - t) * 1e3)
        except Exception as e:     # raised again below, in the main thread
            errors.append(e)

    client = threading.Thread(target=viewer, daemon=True)
    client.start()
    zero_launches()
    t0 = time.perf_counter()
    # the first step waits for the viewer, so that it is iteration 1 the viewer sees
    result = loop.training(cfg, device=device, gui_port=port, gui_wait=120)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    seconds = time.perf_counter() - t0
    client.join(timeout=60)
    if client.is_alive() or errors:
        raise RuntimeError(f"11b: the viewer failed: {errors or 'no reply'}")
    if len(frames) != GUI_FRAMES + 1 or len(result["history"]) != 1:
        raise RuntimeError(f"11b: {len(frames)} frames, {len(result['history'])} steps")
    equal = [image == want for image, _ in frames]
    if not all(equal) or {v for _, v in frames} != {train_scene}:
        raise RuntimeError(f"11b: frames byte-equal to the created field's render: "
                           f"{equal}")
    if launches["blend_fwd"] < GUI_FRAMES + 2 or min(launches.values()) < 1:
        raise RuntimeError(f"11b: launches {launches}")
    out = dict(frame_ms=frame_ms, frames=len(frames), seconds=seconds,
               reference_seconds=ref_s, launches=launches,
               drawn_share=float(np.frombuffer(want, np.uint8).astype(bool).mean()))
    log(f"phase 11b: {len(frames)} frames of {WIDTH}x{HEIGHT} byte-equal to K1's render "
        f"of the created field; " + json.dumps(out))
    return out


class PrefetchWaits:
    """Records how long each `FeaturePrefetcher.get` blocks the training loop, and
    which path (`cameras.FEATURE_LOADS`, zeroed on entry) the loads took."""

    def __enter__(self):
        from langsplat_tpu_torch.data import cameras, prefetch
        self.cameras, self.prefetch = cameras, prefetch
        self.plain_get = prefetch.FeaturePrefetcher.get
        self.waits_ms: list[float] = []

        def timed_get(pf, cam):
            t0 = time.perf_counter()
            value = self.plain_get(pf, cam)
            self.waits_ms.append((time.perf_counter() - t0) * 1e3)
            return value

        prefetch.FeaturePrefetcher.get = timed_get
        for key in cameras.FEATURE_LOADS:
            cameras.FEATURE_LOADS[key] = 0
        return self

    def __exit__(self, *exc):
        self.prefetch.FeaturePrefetcher.get = self.plain_get
        self.loads = dict(self.cameras.FEATURE_LOADS)


def loader_phase(train_scene: str, waits: PrefetchWaits) -> dict:
    """11c: `get_language_feature` of view 0 at 1024x768 through the native loader and
    through numpy (median of LOADER_REPS, bit-equal), and the prefetcher's waits in
    phase 5's phase-B steps, every load of which must have been native."""
    from langsplat_tpu_torch.data import cameras
    cam = load_camera(read_colmap_scene(train_scene).train_cameras[0], 1.0, -1, uid=0)
    lf_dir = os.path.join(train_scene, "language_features_dim3")
    base = os.path.join(lf_dir, cam.image_name)

    def median_ms(fn):
        times, value = [], None
        for _ in range(LOADER_REPS):
            t0 = time.perf_counter()
            value = fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), value

    native_ms, native_out = median_ms(lambda: cam.get_language_feature(lf_dir, 1))
    numpy_ms, numpy_out = median_ms(
        lambda: cameras.numpy_language_feature(base, 1, cam.height, cam.width))
    equal = all(np.array_equal(a, b) for a, b in zip(native_out, numpy_out))
    if not equal:
        raise RuntimeError("11c: the native and numpy loaders differ")
    if waits.loads["numpy"] != 0 or waits.loads["native"] < 1:
        raise RuntimeError(f"11c: phase B's loads took the paths {waits.loads}")
    out = dict(native_ms=native_ms, numpy_ms=numpy_ms, bit_equal=equal,
               prefetch_wait_ms_median=float(np.median(waits.waits_ms)),
               prefetch_wait_ms=waits.waits_ms, phase_b_loads=waits.loads)
    log("phase 11c: " + json.dumps(out))
    return out


def small_scene(n: int, w: int, h: int, seed: int, device):
    """A bench-box scene of n Gaussians scaled 8x on a small w x h view: (Gaussians,
    preprocess output, instance buffer); phase 2's comparisons run on these."""
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
    return g, prep, inst


def tiled_phase(model_dir: str, scene_dir: str, device) -> dict:
    """11d: view 0 of phase 3's field through the render path with the tiled backend
    (--interpret), against K1 on every untruncated tile; then the tiled backward on a
    small scene no tile of which is truncated: bit-equal over two runs, through K3, and
    against the plain blend's gradients on the CPU."""
    from langsplat_tpu_torch.ops.rasterize_tiled import rasterize_tiled, truncated_tiles
    field = field_io.load_field(os.path.join(model_dir, "chkpnt1.npz"), device=device)[0]
    cam = load_camera(read_colmap_scene(scene_dir).train_cameras[0], 1.0, -1, uid=0)
    bg = [0.0, 0.0, 0.0]
    size = dict(image_height=HEIGHT, image_width=WIDTH, tile_size=TILE)
    with torch.no_grad():
        zero_launches()
        tiled = render_full(field, cam, PipelineConfig(interpret=True), 3, True, bg,
                            device=device)
        torch.cuda.synchronize()
        tiled_launches = dict(_build.LAUNCHES)
        k1 = render_full(field, cam, PipelineConfig(), 3, True, bg, device=device)
        _, _, prep, inst, bargs = blend_inputs(field, cam, PipelineConfig(), True, device)
        counts = inst.tile_start[1:] - inst.tile_start[:-1]
        whole = (counts <= MAX_PER_TILE).reshape(-(-HEIGHT // TILE), -(-WIDTH // TILE))
        whole = whole.repeat_interleave(TILE, 0).repeat_interleave(TILE, 1)[:HEIGHT, :WIDTH]
        errs = {}
        for key in ("render", "language_feature_image", "final_transmittance"):
            diff = (tiled[key] - k1[key]).abs()
            diff = diff if diff.dim() == 3 else diff[None]
            errs[key] = float(diff[:, whole].max())
        truncated = truncated_tiles(inst, MAX_PER_TILE)
        tiled_render_ms = host_ms(lambda: render_full(
            field, cam, PipelineConfig(interpret=True), 3, True, bg, device=device), reps=2)
        k1_render_ms = host_ms(lambda: render_full(
            field, cam, PipelineConfig(), 3, True, bg, device=device), reps=3)
        tiled_blend_ms = cuda_ms(lambda: rasterize_tiled(
            prep, inst, bargs[2], bargs[5], bargs[8], max_per_tile=MAX_PER_TILE, **size),
            reps=2)
    del field, tiled, k1, prep, inst, bargs
    if sum(tiled_launches.values()) != 0:
        raise RuntimeError(f"11d: the tiled render launched kernels {tiled_launches}")
    if not max(errs.values()) <= TILED_TOL:
        raise RuntimeError(f"11d: the tiled render differs from K1's on untruncated "
                           f"tiles: {errs}")

    # the backward: leaves of the blend on a small scene, the card twice, the CPU once
    w, h = 77, 53
    g, prep, inst = small_scene(600, w, h, 1, device)
    if truncated_tiles(inst, MAX_PER_TILE):
        raise RuntimeError("11d: the small scene truncates a tile")
    feats = torch.nn.functional.normalize(torch.randn((600, 3), device=device), dim=1)
    target = torch.rand((3, h, w), device=device)
    ftarget = torch.rand((3, h, w), device=device)
    leaves = (prep.means2d, prep.conics, g["opac"], prep.colors, feats)
    bg_t = torch.rand(3, device=device)

    def grads(blend, on):
        xs = [x.detach().to(on).requires_grad_(True) for x in leaves]
        p = prep._replace(**{k: v.to(on) for k, v in prep._asdict().items()})
        p = p._replace(means2d=xs[0], conics=xs[1], colors=xs[3])
        i = dataclasses.replace(inst, **{f.name: getattr(inst, f.name).to(on)
                                         for f in dataclasses.fields(inst)
                                         if isinstance(getattr(inst, f.name),
                                                       torch.Tensor)})
        out = blend(p, i, xs[2], xs[4], bg_t.to(on))
        loss = (((out["render"] - target.to(on)) ** 2).mean()
                + ((out["language_feature_image"] - ftarget.to(on)) ** 2).mean()
                + 0.1 * out["final_transmittance"].mean())
        return torch.autograd.grad(loss, xs)

    def tiled_blend(p, i, opac, f, bg_):
        return rasterize_tiled(p, i, opac, f, bg_, max_per_tile=MAX_PER_TILE,
                               image_height=h, image_width=w, tile_size=TILE)

    zero_launches()
    first = grads(tiled_blend, device)
    second = grads(tiled_blend, device)
    torch.cuda.synchronize()
    bwd_launches = dict(_build.LAUNCHES)
    plain = grads(lambda p, i, opac, f, bg_: rasterize_cuda.rasterize(
        p, i, opac, f, bg_, image_height=h, image_width=w, tile_size=TILE), "cpu")
    bit_equal = all(torch.equal(a, b) for a, b in zip(first, second))
    grad_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(first, plain))
    if not bit_equal or bwd_launches != {"blend_fwd": 0, "blend_bwd": 0, "segsum": 2}:
        raise RuntimeError(f"11d: tiled backward bit-equal {bit_equal}, launches "
                           f"{bwd_launches}")
    if not grad_err <= TILED_GRAD_TOL:
        raise RuntimeError(f"11d: tiled gradients differ from the plain blend's by "
                           f"{grad_err}")
    out = dict(truncated_tiles=truncated, tiles=int(counts.numel()),
               max_abs_err_untruncated=errs, tiled_render_ms=tiled_render_ms,
               k1_render_ms=k1_render_ms, tiled_blend_ms=tiled_blend_ms,
               render_launches=tiled_launches, backward_launches=bwd_launches,
               backward_bit_equal=bit_equal, backward_max_abs_err=grad_err,
               backward_instances=int(inst.num_instances))
    log("phase 11d: " + json.dumps(out))
    return out


def metrics_phase(seed: int, device) -> dict:
    """11e: the LPIPS arithmetic on the card against the CPU, on AlexNet-shaped layer
    features of a 1024x768 image pair and lin weights made from --seed (the backbone's
    weights are not in the repository)."""
    from langsplat_tpu_torch.utils import metrics
    rng = np.random.default_rng(seed + 11)
    fa, fb = ([torch.tensor(rng.standard_normal(shape, dtype=np.float32))
               for shape in ALEX_LAYERS] for _ in range(2))
    lin = [torch.tensor(rng.uniform(0.0, 1.0, c).astype(np.float32) / c)
           for c, _, _ in ALEX_LAYERS]
    image = torch.tensor(rng.uniform(size=(3, HEIGHT, WIDTH)).astype(np.float32))

    def on(xs):
        return [x.to(device) for x in xs]

    dist = metrics.lpips_distance(on(fa), on(fb), on(lin))
    ref = metrics.lpips_distance(fa, fb, lin)
    errs = dict(
        lpips_distance=abs(float(dist) - float(ref)),
        normalize_tensor=max(float((metrics.normalize_tensor(x.to(device)).cpu()
                                    - metrics.normalize_tensor(x)).abs().max())
                             for x in fa),
        scale_image_for_lpips=float((metrics.scale_image_for_lpips(image.to(device)).cpu()
                                     - metrics.scale_image_for_lpips(image)).abs().max()))
    out = dict(lpips_distance=float(dist), max_abs_err=errs, tol=LPIPS_TOL)
    log("phase 11e: " + json.dumps(out))
    if not max(errs.values()) <= LPIPS_TOL:
        raise RuntimeError(f"11e: the LPIPS arithmetic differs between card and CPU: {errs}")
    return out


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
                evaluated, blended, blended_in = rasterize_cuda.blend_pairs(*bargs, **size)
                bound, bound_by, work = blend_bound(bargs, HEIGHT, WIDTH,
                                                    int(inst.num_instances),
                                                    (evaluated, blended))
                timings[mode].update(bound_ms=bound, bound_by=bound_by, **work,
                                     **cull_shares(bargs, inst, blended_in))
                del blended_in
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
        with PrefetchWaits() as prefetch_waits:     # read by phase 11c
            result_b = run_training_phase(
                "B", ["-s", train_scene, "-m", run_prefix, "--quiet", "--feature_level",
                      "1", "--iterations", str(TRAIN_STEPS), "--sh_degree", "3",
                      *BUDGET_FLAGS, "--start_checkpoint", checkpoint,
                      "--test_iterations", "999999", "--save_iterations", str(TRAIN_STEPS),
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
        del result_b

        # 8 + 9. the autoencoder, then the eval on phase 3's field
        t0 = time.perf_counter()
        ae = autoencoder_phase(tmp, args.seed, device)
        t1 = time.perf_counter()
        evaluation = eval_phase(tmp, args.seed, device, model_dir, scene_dir, ae)
        log(f"phases 8-9: {t1 - t0:.1f} s + {time.perf_counter() - t1:.1f} s, inputs, "
            f"checks and timings included")

        # 10. the language-feature preprocessing
        t0 = time.perf_counter()
        preprocessing = preprocess_phase(tmp, args.seed, device)
        log(f"phase 10: {time.perf_counter() - t0:.1f} s, inputs, checks and timings "
            f"included")
        t0 = time.perf_counter()
        preprocessing["published_widths"] = published_widths_phase(tmp, args.seed, device)
        log(f"phase 10b: {time.perf_counter() - t0:.1f} s")

        # 11. the rest of the single-device surface
        t0 = time.perf_counter()
        surface = dict(trace=trace_phase(tmp, train_scene, run_prefix),
                       gui=gui_phase(train_scene, args.seed, device),
                       loader=loader_phase(train_scene, prefetch_waits),
                       tiled=tiled_phase(model_dir, scene_dir, device),
                       metrics=metrics_phase(args.seed, device))
        log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    for ph in ("A", "B"):
        for key, err in train_timings[ph]["errors"].items():
            errors[key] = max(errors[key], err)
    if not (errors["blend_fwd"] <= TOL and errors["blend_bwd_rel"] <= BWD_TOL
            and errors["segsum_rel"] <= SEG_TOL):
        raise RuntimeError(f"a kernel disagrees with its plain version: {errors}")

    feat = timings["features"]
    ta, tb = train_timings["A"], train_timings["B"]
    # launches on each path, each counted from zero just before the path ran
    paths = {"render": render_launches, "train_A": train_logs["A"]["launches"],
             "train_B": train_logs["B"]["launches"],
             "trace_A": surface["trace"]["A"]["launches"],
             "trace_B": surface["trace"]["B"]["launches"],
             "gui": surface["gui"]["launches"],
             "tiled_render": surface["tiled"]["render_launches"],
             "tiled_backward": surface["tiled"]["backward_launches"]}
    launches = {k: sum(p[k] for p in paths.values()) for k in _build.LAUNCHES}
    by_path = {k: {name: p[k] for name, p in paths.items() if p[k]} for k in launches}
    # `max_abs_err` is absolute for every kernel; each is held to `tol` of the kind
    # `tol_of` names, against `max_rel_err` where that is row-relative; the numbers
    # after `tol_of` are the same kernel on the training path's view 0 (phase A, B)
    kernels = [
        dict(name="blend_fwd", route="cuda", source="langsplat_tpu_torch/csrc/blend_fwd.cu",
             replaces="langsplat_tpu/ops/rasterize_pallas.py:597",
             launches=launches["blend_fwd"], launches_by_path=by_path["blend_fwd"],
             max_abs_err=errors["blend_fwd"],
             ms=feat["blend_ms"], plain_ms=feat["plain_ms"], bound_ms=feat["bound_ms"],
             bound_by=feat["bound_by"], library_ms=None, tol=TOL, tol_of="absolute",
             bound_counts="blended pairs",
             bound_evaluated_ms=feat["bound_evaluated_ms"],
             cull_kept_share=feat["cull_kept_share"], cull_counted_by=CULL_COUNTED_BY,
             train_ms=[ta["blend_fwd_ms"], tb["blend_fwd_ms"]],
             train_bound_ms=[ta["blend_fwd_bound_ms"], tb["blend_fwd_bound_ms"]],
             train_bound_evaluated_ms=[t["blend_fwd_work"]["bound_evaluated_ms"]
                                       for t in (ta, tb)],
             train_cull_kept_share=[ta["cull_kept_share"], tb["cull_kept_share"]]),
        dict(name="blend_bwd", route="cuda", source="langsplat_tpu_torch/csrc/blend_bwd.cu",
             replaces="langsplat_tpu/ops/rasterize_pallas.py:746",
             launches=launches["blend_bwd"], launches_by_path=by_path["blend_bwd"],
             max_abs_err=errors["blend_bwd"],
             ms=ta["blend_bwd_ms"], plain_ms=ta["blend_bwd_plain_ms"],
             bound_ms=ta["blend_bwd_bound_ms"], bound_by=ta["blend_bwd_bound_by"],
             library_ms=None, max_rel_err=errors["blend_bwd_rel"], tol=BWD_TOL,
             tol_of="row-relative", bound_counts="blended pairs",
             bound_evaluated_ms=ta["blend_bwd_work"]["bound_evaluated_ms"],
             feature_ms=tb["blend_bwd_ms"], feature_bound_ms=tb["blend_bwd_bound_ms"],
             feature_bound_by=tb["blend_bwd_bound_by"],
             feature_bound_evaluated_ms=tb["blend_bwd_work"]["bound_evaluated_ms"],
             cull_kept_share=[ta["cull_kept_share"], tb["cull_kept_share"]],
             cull_counted_by=CULL_COUNTED_BY),
        dict(name="segsum", route="cuda", source="langsplat_tpu_torch/csrc/segsum.cu",
             replaces="langsplat_tpu/ops/segsum_pallas.py:42",
             launches=launches["segsum"], launches_by_path=by_path["segsum"],
             max_abs_err=errors["segsum"],
             ms=ta["segsum_ms"], plain_ms=ta["segsum_plain_ms"],
             bound_ms=ta["segsum_bound_ms"], bound_by=ta["segsum_bound_by"],
             library_ms=ta["segsum_library_ms"], max_rel_err=errors["segsum_rel"],
             tol=SEG_TOL, tol_of="row-relative", feature_ms=tb["segsum_ms"],
             feature_bound_ms=tb["segsum_bound_ms"],
             feature_library_ms=tb["segsum_library_ms"]),
    ]
    log("training path launches: " + json.dumps(
        {ph: train_logs[ph]["launches"] for ph in train_logs}))
    log("phase 9: " + json.dumps(evaluation))
    log("phase 10: " + json.dumps(preprocessing))
    log("phase 11: " + json.dumps(surface))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
