#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU: builds the port's CUDA
kernels from this checkout, holds each against its plain PyTorch version, renders a
full-width trained scene through the port's render CLI, and times the render path.

    python3 chip_smoke.py [--seed 0]

Phases (any failure ends the run with a non-zero exit):
  1. the device: name, count, and `nvidia-smi` name and power limit;
  2. the blend kernel (csrc/blend_fwd.cu) is built with nvcc, then compared with its
     plain version on random scenes at small odd sizes (F = 0 and 3);
  3. the main path: a synthetic COLMAP scene (3 cameras at 1024x768) and a trained
     model of 1M Gaussians (sh_degree 3, 3 language-feature channels, made from
     --seed) written as PLY + npz checkpoint, rendered by
     `langsplat_tpu_torch.cli.render_cli.main` for RGB and --include_feature; the
     kernel launch counters are zeroed just before and read just after; then the
     kernel is compared with its plain version on the main path's own full-width
     inputs;
  4. timings at full width, view 0: one whole `render_full` (host clock, ending in a
     synchronize), and with CUDA events preprocess, binning and the blend kernel, the
     plain version's time, and the kernel's bound from this run's work.
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
    from langsplat_tpu_torch.config import PipelineConfig
    from langsplat_tpu_torch.data.cameras import load_camera
    from langsplat_tpu_torch.data.dataset import read_colmap_scene
    from langsplat_tpu_torch.models import field_io
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    from langsplat_tpu_torch.ops import _build, projection, rasterize_cuda, tiles
    from langsplat_tpu_torch.train.loop import make_settings, render_full
except ImportError as e:  # run outside a checkout of the repository
    print(f"chip_smoke: cannot import the port ({e}); run it from the repository root",
          file=sys.stderr)
    sys.exit(2)

WIDTH, HEIGHT, TILE = 1024, 768, 16
N_FULL = 1_000_000
N_VIEWS = 3
FOV_X = 0.9
TOL = 2e-4            # kernel vs plain: see tests/test_torch_cuda.py
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


def write_colmap_scene(root: str, seed: int) -> None:
    """COLMAP binary model (one PINHOLE camera, N_VIEWS images looking down +z from
    slightly different positions) plus the images, as written by COLMAP."""
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
    pts = rng.uniform(-3, 3, (100, 3))
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for i, p in enumerate(pts):
            f.write(struct.pack("<QdddBBBd", i + 1, *p, 128, 128, 128, 0.5))
            f.write(struct.pack("<Q", 0))
    for i in range(N_VIEWS):
        img = rng.integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", f"view_{i:03d}.png"))


# ---------------------------------------------------------------------------
# Kernel vs plain
# ---------------------------------------------------------------------------

def blend_inputs(field, cam, pipe, include_feature: bool, device):
    """The blend's inputs for one view of `field`, as the main path builds them."""
    settings = make_settings(cam, pipe, 3, include_feature, field.capacity)
    mats = [torch.as_tensor(m, device=device) for m in
            (cam.world_view_transform, cam.full_proj_transform, cam.camera_center)]
    prep = projection.preprocess(
        field.xyz, field.get_scaling, field.rotation, field.get_features, *mats,
        image_height=cam.height, image_width=cam.width, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, sh_degree=3, tile_size=TILE, alive=field.alive)
    opac = field.get_opacity[:, 0]
    inst = tiles.bin_gaussians(prep, grid_x=settings.grid_x, grid_y=settings.grid_y,
                               budget=settings.budget, tile_size=TILE,
                               max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
                               opacities=opac)
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


def small_comparisons(device) -> float:
    """Kernel vs plain on random scenes at small odd sizes, F = 0 and 3."""
    worst = 0.0
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
        for num_feat in (0, 3):
            feats = (torch.nn.functional.normalize(torch.randn((n, 3), device=device),
                                                   dim=1) if num_feat else None)
            args = rasterize_cuda.blend_args(prep, inst, g["opac"], feats,
                                             torch.rand(3, device=device))
            err = compare(args, h, w)
            log(f"  kernel vs plain {w}x{h} n={n} F={num_feat}: max_abs_err {err:.3e}")
            worst = max(worst, err)
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
    """Device time by kernel over `reps` calls of `fn` (torch.profiler), and the share of
    the window's wall time in which the device ran no kernel."""
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
    return dict(wall_ms_per_view=wall_us / reps / 1e3,
                device_ms_per_view=device_us / reps / 1e3,
                device_idle_share=1.0 - device_us / wall_us,
                top_kernels_ms_per_view=[(k[:60], t / reps / 1e3) for k, t in kernels[:8]])


def blend_bound(args, h, w, num_instances: int) -> tuple[float, str, dict]:
    """Least time for the blend on this card: the larger of bytes over HBM rate and
    FP32 operations over the FP32 peak. Bytes: every input read once (per-Gaussian
    arrays, the instances the tiles list, tile ranges, bg) and both outputs written
    once. Operations: from the (instance, pixel) pairs these inputs need, counted by
    the plain version: 11 per evaluated pair (offsets and the conic power) and
    6 + 2C more per blended pair (alpha, transmittance, weight, C accumulations)."""
    means2d, conics, opac, visible, colors, feats, gauss_id, tile_start, bg = args
    c = 3 + (0 if feats is None else feats.shape[1])
    n = means2d.shape[0]
    in_bytes = (n * 4 * (2 + 3 + 1 + 3 + (c - 3)) + n + 4 * num_instances
                + 4 * tile_start.numel() + 4 * 3)
    out_bytes = 4 * (c + 1) * h * w
    evaluated, blended = rasterize_cuda.evaluated_pairs(
        *args, image_height=h, image_width=w, tile_size=TILE)
    ops = 11 * evaluated + (6 + 2 * c) * blended
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    work = dict(bytes=in_bytes + out_bytes, evaluated_pairs=evaluated,
                blended_pairs=blended, fp32_ops=ops)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), work


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
    _build.build(["blend_fwd.cu"])
    log(f"phase 2: built blend_fwd.cu in {time.perf_counter() - t0:.1f} s")
    max_err = small_comparisons(device)

    # 3. the main path: the render CLI at full width
    from langsplat_tpu_torch.cli.render_cli import main as render_main
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
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
        launches = dict(_build.LAUNCHES)
        cli_s = time.perf_counter() - t0
        log(f"phase 3: render CLI, {N_VIEWS} views x (RGB, features) in {cli_s:.1f} s; "
            f"launches {launches}")
        if launches["blend_fwd"] < 2 * N_VIEWS:
            raise RuntimeError(f"blend kernel launched {launches['blend_fwd']} times on "
                               f"the main path, expected >= {2 * N_VIEWS}")
        out_dir = os.path.join(model_dir, "train", "ours_1", "renders_npy")
        outs = [np.load(os.path.join(out_dir, f)) for f in sorted(os.listdir(out_dir))]
        if len(outs) != N_VIEWS:
            raise RuntimeError(f"expected {N_VIEWS} renders, found {len(outs)}")
        for o in outs:
            if o.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(o).all():
                raise RuntimeError(f"bad render: shape {o.shape}")
            if float(o.std()) < 1e-3:
                raise RuntimeError("render is flat: nothing was drawn")

        # the main path's own inputs (view 0, features), kernel vs plain
        cam = load_camera(read_colmap_scene(scene_dir).train_cameras[0], 1.0, -1, uid=0)
        gpu_field = field.to(device)
        pipe = PipelineConfig()
        with torch.no_grad():
            runs = {f: blend_inputs(gpu_field, cam, pipe, f, device)
                    for f in (False, True)}
            full_err = compare(runs[True][4], HEIGHT, WIDTH)
        log(f"phase 3: kernel vs plain on view 0 at full width (F=3): "
            f"max_abs_err {full_err:.3e}")
        max_err = max(max_err, full_err)
        if not max_err <= TOL:
            raise RuntimeError(f"kernel disagrees with its plain version: {max_err} > {TOL}")

        # 4. timings at full width (view 0)
        timings = {}
        with torch.no_grad():
            for feat, (settings, mats, prep, inst, bargs) in runs.items():
                mode = "features" if feat else "rgb"
                size = dict(image_height=HEIGHT, image_width=WIDTH, tile_size=TILE)
                timings[mode] = dict(
                    instances=int(inst.num_instances),
                    render_full_ms=host_ms(lambda: render_full(
                        gpu_field, cam, pipe, 3, feat, [0.0, 0.0, 0.0], device=device),
                        reps=5),
                    preprocess_ms=cuda_ms(lambda: projection.preprocess(
                        gpu_field.xyz, gpu_field.get_scaling, gpu_field.rotation,
                        gpu_field.get_features, *mats, image_height=HEIGHT,
                        image_width=WIDTH, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
                        sh_degree=3, tile_size=TILE, alive=gpu_field.alive), reps=10),
                    binning_ms=cuda_ms(lambda: tiles.bin_gaussians(
                        prep, grid_x=settings.grid_x, grid_y=settings.grid_y,
                        budget=settings.budget, tile_size=TILE,
                        max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
                        opacities=bargs[2]), reps=5),
                    blend_ms=cuda_ms(lambda: rasterize_cuda.blend_forward_cuda(
                        *bargs, **size), reps=20),
                    plain_ms=cuda_ms(lambda: rasterize_cuda.blend_forward_plain(
                        *bargs, **size), reps=2))
                bound, bound_by, work = blend_bound(bargs, HEIGHT, WIDTH,
                                                    int(inst.num_instances))
                timings[mode].update(bound_ms=bound, bound_by=bound_by, **work)
                log(f"phase 4 ({mode}): " + json.dumps(timings[mode]))
                log(f"phase 4 ({mode}) profile: " + json.dumps(profile_render(
                    lambda: render_full(gpu_field, cam, pipe, 3, feat, [0.0, 0.0, 0.0],
                                        device=device))))

    feat = timings["features"]
    kernels = [dict(
        name="blend_fwd", route="cuda", source="langsplat_tpu_torch/csrc/blend_fwd.cu",
        replaces="langsplat_tpu/ops/rasterize_pallas.py:597",
        launches=launches["blend_fwd"], max_abs_err=max_err, ms=feat["blend_ms"],
        plain_ms=feat["plain_ms"], bound_ms=feat["bound_ms"], bound_by=feat["bound_by"],
        library_ms=None)]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
