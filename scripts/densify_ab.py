"""Densification A/B: the port's phase-A densify inputs and decisions against the JAX
package's Pallas path, on trained fields of the quality protocol's scene.

    python scripts/densify_ab.py card --out <dir> [--ws <dir>] [--seeds 0 1 2]
            [--iterations 3100] [--init_ckpt <npz>] [--train_only | --views_only]
            [--smoke] [--device cpu]
        The port alone (runs where JAX is absent, on the CUDA card by default): stage
        the protocol's scene (`quality.run --stages scene`), train phase A through the
        train CLI with the protocol's flags once per seed, and write to <out>:
          curves.json      per seed, the alive Gaussians after every densify round
                           (from the progress line after it; the last round from the
                           returned field) and the test PSNR at 2,500;
          ckpt/            seed 0's checkpoints at CHECKPOINTS, the same arrays,
                           compressed: the first whole (field, Adam state and
                           DensifyStats), the others without the Adam state (the
                           whole ones stay in the workspace);
          scene/           the scene's images and sparse model;
          card.npz         the port's phase-A step (K1-K3 on the card) from each
                           checkpoint for the views of `views()`, and the statistics
                           after the steps from the first checkpoint to its next
                           densify round.
        --views_only skips staging and training and reads <out>/ckpt and <out>/scene;
        --train_only writes curves.json alone; --init_ckpt trains from that field.

    python scripts/densify_ab.py tpu_init --out <dir>
        The JAX package's initial field of <out>/scene with its KNN at the TPU's
        Precision.DEFAULT, as a checkpoint for --init_ckpt: <out>/tpu_init.npz.

    python scripts/densify_ab.py compare --out <dir> [--ckpts ...] [--variants a t b]
        On the CPU, both packages, from each checkpoint and for the same views:
          a  the JAX `train_step_rgb` with backend="pallas", interpret=True (the TPU
             kernels' own code, in float32);
          t  a, with the TPU's Precision.DEFAULT matmuls emulated: their operands
             rounded to bfloat16 (single-pass MXU products, float32 accumulation);
          b  the port's `train_step_rgb` on the CPU (the kernels' plain versions);
          c  the card's outputs from <out>/card.npz.
        Prints and writes <out>/ab.json: visible Gaussians and radii that differ,
        the share of Gaussians whose densify statistic differs by more than REL_TOL, and
        the hot / clone / split / prune decisions after the views are added to the
        checkpoint's statistics (the size threshold on from 3,000, as the loop has it).

    python scripts/densify_ab.py float64 --out <dir> --ckpts 2900
        How far a, b and c lie from the port's plain step run in float64, on the first
        view of each checkpoint: <out>/float64.json.

    python scripts/densify_ab.py steps --out <dir> [--variants a t b]
        Each variant trains the steps from the first checkpoint to its next densify round
        (500 -> 600) and compares the decisions there with b's and the card's.

    python scripts/densify_ab.py collect --out <dir> --runs base=<dir> ... [--report f]
        The card runs' curves and the CPU half's readings in one file
        (DENSIFY_AB.json).

At 960x720 the JAX interpret path fits the CPU (~30 s a step, ~3.6 GB). Rehearse at the
smoke size: `card --smoke --device cpu --out <dir>`, then `compare --smoke --out <dir>`
and `steps --smoke --out <dir>`.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.append(REPO)          # after PYTHONPATH: `float64` runs a copy of the port

CHECKPOINTS = (500, 1000, 2900, 3000)
SMOKE_CHECKPOINTS = (10, 20, 30, 40)
N_VIEWS = 3
REL_TOL = 1e-3            # the densify statistic's relative tolerance
SIGNIFICANT = 0.01        # ... held for Gaussians above this share of the largest
LAMBDA_DSSIM = 0.2
TMAX0 = 32                # the pipeline's max_tiles_per_gaussian
#: the compared pairs: a JAX Pallas interpret, t a with the TPU's bf16 DEFAULT
#: matmuls, b the port on the CPU, c the port on the card
PAIRS = (("a", "b"), ("b", "c"), ("a", "c"), ("a", "t"), ("t", "b"), ("t", "c"))
PROGRESS = re.compile(r"iter (\d+): \S+ n=(\d+)")
PSNR = re.compile(r"\[ITER (\d+)\] Evaluating test: L1 \S+ PSNR (\S+)")


def params_of(smoke: bool):
    from langsplat_tpu_torch.quality.scene import QualityParams
    return QualityParams.smoke() if smoke else QualityParams()


def checkpoints_of(smoke: bool) -> tuple:
    return SMOKE_CHECKPOINTS if smoke else CHECKPOINTS


def protocol_argv(p, scene_dir: str, out: str, iterations: int, seed: int,
                  checkpoints, device, init_ckpt: str = "") -> list[str]:
    """The train CLI's phase-A flags of `quality/run.py stage_phase_a`, cut to
    `iterations` (tests every 2,500), from `init_ckpt`'s field when given."""
    return (["-s", scene_dir, "-m", out, "--no_include_feature", "--eval",
             "--resolution", "1", "--iterations", str(iterations),
             "--densify_from_iter", str(p.densify_from),
             "--densification_interval", str(p.densification_interval),
             "--densify_until_iter", str(p.densify_until),
             "--opacity_reset_interval", str(p.opacity_reset_interval),
             "--densify_grad_threshold", str(p.densify_grad_threshold),
             "--initial_capacity_factor", "6",
             "--test_iterations"] + [str(t) for t in range(p.test_every, iterations + 1,
                                                           p.test_every)] + [
             "--save_iterations", str(iterations),
             "--checkpoint_iterations"] + [str(c) for c in checkpoints]
            + ["--seed", str(seed), "--budget_factor", str(p.budget_factor)]
            + (["--start_checkpoint", init_ckpt] if init_ckpt else [])
            + (["--device", device] if device else []))


def schedule_position(n_train: int, seed: int, idx: int) -> int:
    """The train camera (index into the scene's seeded train list) the loop takes at
    schedule index `idx` (iteration idx + 1): `train/loop.py Schedule`."""
    epoch, pos = divmod(idx, n_train)
    order = list(range(n_train))
    random.Random(seed * 1_000_003 + epoch).shuffle(order)
    return order[pos]


def views(ck: int, n_train: int, seed: int = 0) -> list[int]:
    """The views of the A/B from the checkpoint at iteration `ck`: those the run takes
    next (iterations ck + 1 .. ck + N_VIEWS)."""
    return [schedule_position(n_train, seed, ck + j) for j in range(N_VIEWS)]


def load_scene(scene_dir: str, seed: int = 0):
    """The scene's cameras at full size (960x720 for the protocol's), as phase A has
    them."""
    from langsplat_tpu_torch.config import ModelConfig
    from langsplat_tpu_torch.data.scene import Scene
    return Scene(ModelConfig(source_path=scene_dir, resolution=1, eval=True),
                 device="cpu", seed=seed, create_field=False)


def camera_arrays(cam) -> dict:
    return dict(viewmatrix=np.asarray(cam.world_view_transform, np.float32),
                projmatrix=np.asarray(cam.full_proj_transform, np.float32),
                campos=np.asarray(cam.camera_center, np.float32),
                image=np.asarray(cam.image, np.float32))


#: the field leaves of a phase-A checkpoint (no language feature), in file order
RGB_LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
              "alive")


def leaf(ck: dict, name: str) -> np.ndarray:
    return ck[f"field_{RGB_LEAVES.index(name)}"]


def read_ckpt(path: str) -> dict:
    with np.load(path, allow_pickle=False) as d:
        return {k: d[k] for k in d.files}


# ---------------------------------------------------------------------------
# the port (b on the CPU, c on the card)
# ---------------------------------------------------------------------------

def tile_cap(leaves: dict, cam) -> int:
    """The per-Gaussian tile cap the train loop's `TmaxPolicy` reaches on this view:
    TMAX0 doubled until every visible Gaussian's tile rect fits, at most the grid. The
    blend's result does not depend on it once nothing is dropped."""
    import torch

    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    from langsplat_tpu_torch.ops import projection
    f = from_numpy(leaves, "cpu")
    a = {k: torch.as_tensor(v) for k, v in camera_arrays(cam).items()}
    with torch.no_grad():
        prep = projection.preprocess(
            f.xyz, f.get_scaling, f.rotation, None, a["viewmatrix"], a["projmatrix"],
            a["campos"], image_height=cam.height, image_width=cam.width,
            tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, sh_degree=0, tile_size=16,
            colors_precomp=torch.zeros((f.capacity, 3)), alive=f.alive)
    area = torch.prod(prep.tiles_max - prep.tiles_min, dim=-1)
    need = int(torch.where(prep.visible, area, 0).max())
    tmax, grid = TMAX0, (-(-cam.width // 16)) * (-(-cam.height // 16))
    while tmax < min(need, grid):
        tmax = min(2 * tmax, grid)
    return tmax


def field_leaves(field) -> dict:
    """A field's RGB leaves as numpy arrays (either package's field)."""
    return {n: (getattr(field, n).detach().cpu().numpy() if hasattr(getattr(field, n),
                                                                   "detach")
                else np.asarray(getattr(field, n))) for n in RGB_LEAVES}


def checked(s):
    """A step's output, raising if its render dropped instances or tile positions."""
    if int(s.dropped) or int(s.rect_dropped):
        raise RuntimeError(f"the step dropped {int(s.dropped)} instances and "
                           f"{int(s.rect_dropped)} tile positions")
    return s


def port_settings(cam, capacity: int, deg: int, budget_factor: int, tmax: int):
    from langsplat_tpu_torch.ops.render import RenderSettings
    return RenderSettings(image_height=cam.height, image_width=cam.width,
                          tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, sh_degree=deg,
                          include_feature=False, budget=budget_factor * capacity,
                          max_tiles_per_gaussian=tmax, grad_mode="full")


def port_state(ck: dict, device):
    """(field, opt_state, stats, step, spatial_lr_scale, active_sh_degree) of a
    checkpoint's arrays on `device`."""
    import torch

    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    from langsplat_tpu_torch.train.densify import STAT_NAMES, DensifyStats
    from langsplat_tpu_torch.train.trainer import opt_state_from_numpy
    field = from_numpy({n: leaf(ck, n) for n in RGB_LEAVES}, device)
    opt_keys = sorted((k for k in ck if k.startswith("opt_")),
                      key=lambda k: int(k.split("_")[1]))
    opt = (opt_state_from_numpy([ck[k] for k in opt_keys], False, device)
           if opt_keys else None)
    stats = DensifyStats(*(torch.as_tensor(ck[f"stats_{i}"], device=device)
                           for i in range(len(STAT_NAMES))))
    return (field, opt, stats, int(ck["__step"]), float(ck["__spatial_lr_scale"]),
            int(ck["__active_sh_degree"]))


def port_views(ck: dict, cams, budget_factor: int, device) -> dict:
    """The port's phase-A step from the checkpoint's field for each camera, from zero
    statistics: per view the densify statistic (|d means2d| in half-image units where
    visible), the radii and the loss."""
    import torch

    from langsplat_tpu_torch.train import densify as dn
    from langsplat_tpu_torch.train import trainer as tr
    from langsplat_tpu_torch.config import OptimizationConfig
    field, opt, _, _, slr, deg = port_state(ck, device)
    optimizer = tr.make_optimizer(OptimizationConfig(), slr, False)
    if opt is None:
        opt = optimizer.init(tr.extract_params(field, False))
    bg = torch.zeros(3, device=device)
    out = {"stat": [], "radii": [], "loss": []}
    for cam in cams:
        t = {k: torch.as_tensor(v, device=device) for k, v in camera_arrays(cam).items()}
        s = checked(tr.train_step_rgb(
            field, opt, dn.DensifyStats.zeros(field.capacity, device), t["viewmatrix"],
            t["projmatrix"], t["campos"], t["image"], bg,
            settings=port_settings(cam, field.capacity, deg, budget_factor,
                                   tile_cap(field_leaves(field), cam)),
            optimizer=optimizer, lambda_dssim=LAMBDA_DSSIM))
        out["stat"].append(s.stats.grad_accum.cpu().numpy())
        out["radii"].append(s.stats.max_radii2d.cpu().numpy().astype(np.int16))
        out["loss"].append(float(s.loss))
    return {k: np.asarray(v) for k, v in out.items()}


def port_steps(ck: dict, cams_of_iteration, last: int, budget_factor: int,
               device) -> dict:
    """The port trains from the checkpoint through iteration `last` (no densify round
    in between) and returns its statistics and field before the round at `last`."""
    import torch

    from langsplat_tpu_torch.config import OptimizationConfig
    from langsplat_tpu_torch.train import trainer as tr
    field, opt, stats, step, slr, deg = port_state(ck, device)
    optimizer = tr.make_optimizer(OptimizationConfig(), slr, False)
    bg = torch.zeros(3, device=device)
    for it in range(step + 1, last + 1):
        cam = cams_of_iteration(it)
        t = {k: torch.as_tensor(v, device=device) for k, v in camera_arrays(cam).items()}
        s = checked(tr.train_step_rgb(
            field, opt, stats, t["viewmatrix"], t["projmatrix"], t["campos"], t["image"],
            bg, settings=port_settings(cam, field.capacity, deg, budget_factor,
                                       tile_cap(field_leaves(field), cam)),
            optimizer=optimizer, lambda_dssim=LAMBDA_DSSIM))
        field, opt, stats = s.field, s.opt_state, s.stats
    return dict(stats=np.stack([x.cpu().numpy() for x in
                                (stats.grad_accum, stats.denom, stats.max_radii2d)]),
                opacity=field.opacity.detach().cpu().numpy()[:, 0],
                scaling=field.scaling.detach().cpu().numpy(),
                alive=field.alive.cpu().numpy())


# ---------------------------------------------------------------------------
# the card half
# ---------------------------------------------------------------------------

def nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def read_curve(log_path: str, p, final_alive: int, iterations: int) -> dict:
    """Alive Gaussians after each densify round (the progress line of the next
    multiple of 10 shows the count the round left) and the test PSNR lines."""
    lines = open(log_path).read().splitlines()
    n = {int(m.group(1)): int(m.group(2)) for m in map(PROGRESS.search, lines) if m}
    psnr = {int(m.group(1)): float(m.group(2)) for m in map(PSNR.search, lines) if m}
    rounds = range(p.densify_from + p.densification_interval,
                   min(iterations, p.densify_until - 1) + 1, p.densification_interval)
    after = {r: (n.get(r + 10) if r + 10 in n else final_alive if r == iterations
                 else None) for r in rounds}
    return dict(after_round={str(r): v for r, v in after.items()},
                progress_every_500={str(i): n[i] for i in sorted(n) if i % 500 == 0},
                test_psnr={str(k): v for k, v in psnr.items()})


def card(args) -> None:
    if not args.views_only:
        card_train(args)
    if not args.train_only:
        card_views(args.out, params_of(args.smoke), checkpoints_of(args.smoke),
                   args.device)


def card_train(args) -> None:
    from langsplat_tpu_torch.cli.train_cli import main as train_main
    from langsplat_tpu_torch.ops import _build
    from langsplat_tpu_torch.quality import run as qrun
    p = params_of(args.smoke)
    cks = checkpoints_of(args.smoke)
    device = args.device
    os.makedirs(args.out, exist_ok=True)
    smi = nvidia_smi()
    print("card:", smi, flush=True)
    t0 = time.perf_counter()
    qrun.main(["--ws", args.ws, "--stages", "scene"] + (["--smoke"] if args.smoke else [])
              + (["--device", device] if device else []))
    ws = args.ws + "_smoke" if args.smoke else args.ws
    scene_dir = os.path.join(ws, "scene")
    report = dict(device=smi, iterations=args.iterations, init=args.init_ckpt or None,
                  seeds={}, scene_seconds=time.perf_counter() - t0)
    for seed in args.seeds:
        out = os.path.join(ws, f"ab_seed{seed}")
        shutil.rmtree(out + "_-1", ignore_errors=True)
        log = os.path.join(args.out, f"phaseA_seed{seed}.log")
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        res = qrun.run_logged(train_main, protocol_argv(
            p, scene_dir, out, args.iterations, seed,
            cks if seed == args.seeds[0] and not args.train_only else [args.iterations],
            device, args.init_ckpt), log)
        report["seeds"][str(seed)] = dict(
            read_curve(log, p, int(res["field"].num_alive), args.iterations),
            seconds=time.perf_counter() - t0,
            launches={k: v - before[k] for k, v in _build.LAUNCHES.items()})
        with open(os.path.join(args.out, "curves.json"), "w") as fh:
            json.dump(report, fh, indent=1)
    if args.train_only:
        print("card: trained", json.dumps({s: v["after_round"] for s, v in
                                           report["seeds"].items()}), flush=True)
        return
    # seed 0's checkpoints, compressed, and the scene's images and cameras
    ck_dir = os.path.join(args.out, "ckpt")
    os.makedirs(ck_dir, exist_ok=True)
    ck_src = os.path.join(ws, f"ab_seed{args.seeds[0]}_-1")
    for c in cks:
        ck = read_ckpt(os.path.join(ck_src, f"chkpnt{c}.npz"))
        if c != cks[0]:     # the one-step A/B reads the field and statistics only
            ck = {k: v for k, v in ck.items() if not k.startswith("opt_")}
        np.savez_compressed(os.path.join(ck_dir, f"chkpnt{c}.npz"), **ck)
    for sub in ("images", "sparse"):
        shutil.copytree(os.path.join(scene_dir, sub), os.path.join(args.out, "scene", sub),
                        dirs_exist_ok=True)
    print("card: trained", json.dumps({s: v["after_round"] for s, v in
                                       report["seeds"].items()}), flush=True)


def card_views(out: str, p, cks, device) -> None:
    """c: the port's step from each checkpoint in <out>/ckpt for the A/B's views, on
    `device`, and the steps from the first checkpoint to its next densify round."""
    import torch

    from langsplat_tpu_torch.ops import _build
    dev = torch.device(device or "cuda")
    ck_dir = os.path.join(out, "ckpt")
    cams = load_scene(os.path.join(out, "scene")).get_train_cameras()
    saved = {}
    before = dict(_build.LAUNCHES)
    for c in cks:
        ck = read_ckpt(os.path.join(ck_dir, f"chkpnt{c}.npz"))
        v = port_views(ck, [cams[i] for i in views(c, len(cams))], p.budget_factor, dev)
        saved.update({f"{c}_{k}": x for k, x in v.items()})
    first = read_ckpt(os.path.join(ck_dir, f"chkpnt{cks[0]}.npz"))
    st = port_steps(first, lambda it: cams[schedule_position(len(cams), 0, it - 1)],
                    cks[0] + p.densification_interval, p.budget_factor, dev)
    saved.update({f"steps_{k}": x for k, x in st.items()})
    saved["launches"] = np.array([_build.LAUNCHES[k] - before[k]
                                  for k in sorted(_build.LAUNCHES)])
    np.savez_compressed(os.path.join(out, "card.npz"), **saved)
    print(f"card: views, launches "
          f"{dict(zip(sorted(_build.LAUNCHES), saved['launches'].tolist()))}", flush=True)


# ---------------------------------------------------------------------------
# the JAX package (a, t)
# ---------------------------------------------------------------------------

def jax_setup(tpu_default: bool):
    """Import the JAX package on the CPU; with `tpu_default`, emulate the TPU's
    Precision.DEFAULT in the Pallas kernels' matmuls: both operands rounded to
    bfloat16, products accumulated in float32 (what the MXU does in one pass). On the
    CPU, DEFAULT computes in float32, so interpret mode does not see it."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from langsplat_tpu.ops import rasterize_pallas as rp
    if not hasattr(rp, "_ab_float32_mm"):
        rp._ab_float32_mm = rp._mm
    base = rp._ab_float32_mm

    def mm(a, b, precision=None):
        if precision == jax.lax.Precision.DEFAULT:
            a = a.astype(jnp.bfloat16).astype(jnp.float32)
            b = b.astype(jnp.bfloat16).astype(jnp.float32)
        return base(a, b, precision)

    rp._mm = mm if tpu_default else base
    jax.clear_caches()
    return jax


def jax_state(ck: dict):
    import jax
    import jax.numpy as jnp

    from langsplat_tpu.config import OptimizationConfig
    from langsplat_tpu.models.gaussian_field import GaussianField
    from langsplat_tpu.train import densify as jdn
    from langsplat_tpu.train import trainer as jtr
    field = GaussianField(**{n: jnp.asarray(leaf(ck, n)) for n in RGB_LEAVES},
                          language_feature=None)
    slr = float(ck["__spatial_lr_scale"])
    optimizer = jtr.make_optimizer(OptimizationConfig(), slr, False)
    opt = optimizer.init(jtr.extract_params(field, False))
    opt_keys = sorted((k for k in ck if k.startswith("opt_")),
                      key=lambda k: int(k.split("_")[1]))
    if opt_keys:
        opt = jax.tree.unflatten(jax.tree.structure(opt),
                                 [jnp.asarray(ck[k]) for k in opt_keys])
    stats = jdn.DensifyStats(*(jnp.asarray(ck[f"stats_{i}"]) for i in range(3)))
    return field, opt, stats, optimizer, int(ck["__step"]), int(ck["__active_sh_degree"])


def jax_settings(cam, capacity: int, deg: int, budget_factor: int, tmax: int):
    from langsplat_tpu.ops.render import RenderSettings
    return RenderSettings(image_height=cam.height, image_width=cam.width,
                          tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, sh_degree=deg,
                          include_feature=False, chunk=128,
                          budget=budget_factor * capacity, max_tiles_per_gaussian=tmax,
                          backend="pallas", interpret=True, grad_mode="full")


def jax_step(field, opt, stats, optimizer, cam, deg: int, budget_factor: int):
    import jax.numpy as jnp

    from langsplat_tpu.train import trainer as jtr
    a = camera_arrays(cam)
    tmax = tile_cap(field_leaves(field), cam)
    return checked(jtr.train_step_rgb(
        field, opt, stats, jnp.asarray(a["viewmatrix"]), jnp.asarray(a["projmatrix"]),
        jnp.asarray(a["campos"]), jnp.asarray(a["image"]), jnp.zeros(3, jnp.float32),
        settings=jax_settings(cam, field.capacity, deg, budget_factor, tmax),
        optimizer=optimizer, lambda_dssim=LAMBDA_DSSIM))


def jax_views(ck: dict, cams, budget_factor: int) -> dict:
    from langsplat_tpu.train import densify as jdn
    field, opt, _, optimizer, _, deg = jax_state(ck)
    out = {"stat": [], "radii": [], "loss": []}
    for cam in cams:
        s = jax_step(field, opt, jdn.DensifyStats.zeros(field.capacity), optimizer, cam,
                     deg, budget_factor)
        out["stat"].append(np.asarray(s.stats.grad_accum))
        out["radii"].append(np.asarray(s.stats.max_radii2d).astype(np.int16))
        out["loss"].append(float(s.loss))
    return {k: np.asarray(v) for k, v in out.items()}


def jax_steps(ck: dict, cams_of_iteration, last: int, budget_factor: int) -> dict:
    field, opt, stats, optimizer, step, deg = jax_state(ck)
    for it in range(step + 1, last + 1):
        s = jax_step(field, opt, stats, optimizer, cams_of_iteration(it), deg,
                     budget_factor)
        field, opt, stats = s.field, s.opt_state, s.stats
    return dict(stats=np.stack([np.asarray(x) for x in
                                (stats.grad_accum, stats.denom, stats.max_radii2d)]),
                opacity=np.asarray(field.opacity)[:, 0],
                scaling=np.asarray(field.scaling), alive=np.asarray(field.alive))


def knn_sq_dist(points, tpu_default: bool, k: int = 3, chunk: int = 1024):
    """`langsplat_tpu/ops/knn.py mean_knn_sq_dist`, line for line, with its cross term
    q @ pts.T at the TPU's Precision.DEFAULT when `tpu_default` (operands rounded to
    bfloat16, float32 accumulation); without it, equal to the package's function."""
    import jax
    import jax.numpy as jnp
    n = points.shape[0]
    pad = (-n) % chunk
    pts = jnp.pad(points, ((0, pad), (0, 0)))
    sq = jnp.sum(pts * pts, axis=-1)

    def rounded(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32) if tpu_default else x

    def one_chunk(c):
        q = jax.lax.dynamic_slice_in_dim(pts, c * chunk, chunk)
        qsq = jax.lax.dynamic_slice_in_dim(sq, c * chunk, chunk)
        d2 = qsq[:, None] - 2.0 * (rounded(q) @ rounded(pts).T) + sq[None, :]
        col = jnp.arange(pts.shape[0])
        d2 = jnp.where(col[None, :] >= n, jnp.inf, d2)
        row_global = c * chunk + jnp.arange(chunk)
        d2 = jnp.where(col[None, :] == row_global[:, None], jnp.inf, d2)
        neg_top, _ = jax.lax.top_k(-d2, k)
        return jnp.mean(jnp.maximum(-neg_top, 0.0), axis=-1)

    out = jax.lax.map(one_chunk, jnp.arange(pts.shape[0] // chunk))
    return out.reshape(-1)[:n]


def tpu_init(args) -> None:
    """The JAX package's initial field of the protocol's scene (`create_from_pcd`, the
    capacity of --initial_capacity_factor 6) with its KNN's cross term at the TPU's
    Precision.DEFAULT, written as a phase-A checkpoint at iteration 0 for the train
    CLI's --start_checkpoint; with the float32 KNN's scales beside it."""
    jax = jax_setup(False)
    import jax.numpy as jnp

    from langsplat_tpu.models import gaussian_field as jgf
    from langsplat_tpu.ops import knn as jknn
    from langsplat_tpu_torch.data import dataset as ds
    from langsplat_tpu_torch.models import field_io
    from langsplat_tpu_torch.models.gaussian_field import from_numpy
    info = ds.read_colmap_scene(os.path.join(args.out, "scene"), "images", eval_split=True)
    pts, cols, _ = info.point_cloud
    jp = jnp.asarray(pts, jnp.float32)
    knn = jax.jit(knn_sq_dist, static_argnames=("tpu_default", "k", "chunk"))
    exact = np.asarray(jknn.mean_knn_sq_dist(jp))
    copy = np.asarray(knn(jp, False))
    if not np.array_equal(copy, exact):
        raise RuntimeError("the KNN copy no longer matches langsplat_tpu/ops/knn.py: "
                           f"{np.abs(copy - exact).max()}")
    tpu = np.asarray(knn(jp, True))
    package_knn = jgf.mean_knn_sq_dist
    jgf.mean_knn_sq_dist = lambda x: jnp.asarray(tpu)
    try:
        field = jgf.create_from_pcd(pts, cols, sh_degree=3, capacity=6 * len(pts))
    finally:
        jgf.mean_knn_sq_dist = package_knn
    leaves = {n: np.asarray(getattr(field, n)) for n in RGB_LEAVES}
    path = os.path.join(args.out, "tpu_init.npz")
    field_io.save_field(path, from_numpy(leaves, "cpu"), 0,
                        info.nerf_normalization["radius"], 0)
    scale = {k: np.sqrt(np.maximum(v, 1e-7)) for k, v in (("float32", exact),
                                                            ("tpu_default", tpu))}
    report = dict(points=int(len(pts)), path=os.path.basename(path),
                  at_floor={k: float(np.mean(v <= 1e-7)) for k, v in
                            (("float32", exact), ("tpu_default", tpu))},
                  scale_percentiles={k: np.percentile(v, [10, 50, 90]).tolist()
                                     for k, v in scale.items()})
    print(json.dumps(report), flush=True)
    with open(os.path.join(args.out, "tpu_init.json"), "w") as fh:
        json.dump(report, fh, indent=1)


F64_MODULES = ("ops/rasterize_cuda.py", "ops/segsum.py", "ops/tiles.py", "ops/projection.py",
               "ops/render.py", "core/losses.py", "models/gaussian_field.py")


def float64(args) -> None:
    """How far a, b and c each lie from the exact step: the port's plain step in float64
    (a copy of the package with float32 read as float64 in F64_MODULES, run in a child
    process with float64 as torch's default) on the first view of each checkpoint."""
    import tempfile
    import torch
    p = params_of(args.smoke)
    if args.f64_child:
        torch.set_default_dtype(torch.float64)
        import dataclasses
        from langsplat_tpu_torch.models.gaussian_field import from_numpy
        from langsplat_tpu_torch.train import trainer as tr
        scene = load_scene(os.path.join(args.out, "scene"))
        cams = scene.get_train_cameras()
        for c in args.ckpts:
            ck = read_ckpt(os.path.join(args.out, "ckpt", f"chkpnt{c}.npz"))
            cam = cams[views(c, len(cams))[0]]
            f = from_numpy({n: leaf(ck, n) for n in RGB_LEAVES}, "cpu")
            f = dataclasses.replace(f, **{n: getattr(f, n).double() for n in RGB_LEAVES
                                          if n != "alive"})
            a = {k: torch.as_tensor(v).double() for k, v in camera_arrays(cam).items()}
            _, _, _, _, tap = tr.rgb_loss_and_grads(
                f, a["viewmatrix"], a["projmatrix"], a["campos"], a["image"],
                torch.zeros(3), settings=port_settings(
                    cam, f.capacity, int(ck["__active_sh_degree"]), p.budget_factor,
                    tile_cap({n: leaf(ck, n) for n in RGB_LEAVES}, cam)),
                lambda_dssim=LAMBDA_DSSIM)
            half = torch.tensor([cam.width / 2, cam.height / 2], dtype=torch.float64)
            np.save(os.path.join(args.out, f"f64_{c}.npy"),
                    torch.linalg.vector_norm(tap * half, dim=-1).numpy())
        return
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(REPO, "langsplat_tpu_torch"),
                        os.path.join(tmp, "langsplat_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        for m in F64_MODULES:
            path = os.path.join(tmp, "langsplat_tpu_torch", m)
            with open(path) as fh:
                text = fh.read().replace("torch.float32", "torch.float64")
            with open(path, "w") as fh:
                fh.write(text)
        subprocess.run([sys.executable, os.path.abspath(__file__), "float64",
                        "--f64_child", "--out", args.out, "--ckpts",
                        *map(str, args.ckpts)]
                       + (["--smoke"] if args.smoke else []),
                       check=True, env=dict(os.environ, PYTHONPATH=tmp))
    scene = load_scene(os.path.join(args.out, "scene"))
    cams = scene.get_train_cameras()
    card_saved = read_ckpt(os.path.join(args.out, "card.npz"))
    report = {}
    for c in args.ckpts:
        ck = read_ckpt(os.path.join(args.out, "ckpt", f"chkpnt{c}.npz"))
        cam = [cams[views(c, len(cams))[0]]]
        ref = np.load(os.path.join(args.out, f"f64_{c}.npy"))
        runs = {"b": port_views(ck, cam, p.budget_factor, "cpu")["stat"][0],
                "c": card_saved[f"{c}_stat"][0]}
        jax_setup(False)
        runs["a"] = jax_views(ck, cam, p.budget_factor)["stat"][0]
        report[str(c)] = {k: stat_diff(ref, v) for k, v in sorted(runs.items())}
        print(json.dumps({c: report[str(c)]}), flush=True)
    with open(os.path.join(args.out, "float64.json"), "w") as fh:
        json.dump(report, fh, indent=1)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def decisions(stats: np.ndarray, opacity_logit: np.ndarray, scaling_log: np.ndarray,
              alive: np.ndarray, *, extent: float, grad_threshold: float,
              use_size_threshold: bool, percent_dense: float = 0.01,
              min_opacity: float = 0.005, size_threshold: float = 20.0) -> dict:
    """The masks of `train/densify.py densify_core` (both packages' lines agree) in
    numpy, and the mean statistic they threshold."""
    grad_accum, denom, max_radii = stats
    grads = np.where(denom > 0, grad_accum / np.maximum(denom, 1e-30), 0.0)
    max_scale = np.exp(scaling_log).max(axis=-1)
    opa = 1.0 / (1.0 + np.exp(-opacity_logit))
    hot = alive & (grads >= grad_threshold)
    small = max_scale <= percent_dense * extent
    prune = opa < min_opacity
    if use_size_threshold:
        prune = prune | (max_radii > size_threshold) | (max_scale > 0.1 * extent)
    split = hot & ~small
    return dict(grads=grads, hot=hot, clone=hot & small, split=split,
                prune=alive & (prune | split))


def stat_diff(x: np.ndarray, y: np.ndarray) -> dict:
    """Relative differences of two per-Gaussian statistics: over the Gaussians where
    either is non-zero, and over those above SIGNIFICANT of the largest."""
    scale = np.maximum(np.abs(x), np.abs(y))
    nz = scale > 0
    rel = np.where(nz, np.abs(x - y) / np.where(nz, scale, 1.0), 0.0)
    sig = scale > SIGNIFICANT * scale.max() if nz.any() else nz
    return dict(nonzero=int(nz.sum()), over_tol=int((rel[nz] > REL_TOL).sum()),
                share_over_tol=float((rel[nz] > REL_TOL).mean()) if nz.any() else 0.0,
                significant=int(sig.sum()),
                significant_over_tol=int((rel[sig] > REL_TOL).sum()),
                max_rel_significant=float(rel[sig].max()) if sig.any() else 0.0,
                median_rel=float(np.median(rel[nz])) if nz.any() else 0.0,
                sum_ratio=float(y.sum() / x.sum()) if x.sum() else None)


def decision_diff(dx: dict, dy: dict, threshold: float) -> dict:
    """Masks that differ, and how many of those Gaussians lie within REL_TOL of the
    threshold in either run."""
    near = (np.abs(dx["grads"] - threshold) <= REL_TOL * threshold) | (
        np.abs(dy["grads"] - threshold) <= REL_TOL * threshold)
    out = {}
    for k in ("hot", "clone", "split", "prune"):
        d = dx[k] != dy[k]
        out[k] = dict(count=[int(dx[k].sum()), int(dy[k].sum())], differ=int(d.sum()),
                      differ_not_near=int((d & ~near).sum()))
    return out


def compare_views(name_x: str, x: dict, name_y: str, y: dict) -> dict:
    vis_x, vis_y = x["radii"] > 0, y["radii"] > 0
    return dict(pair=f"{name_x}-{name_y}",
                visible=[int(vis_x.sum()), int(vis_y.sum())],
                visibility_differs=int((vis_x != vis_y).sum()),
                radii_differ=int((x["radii"] != y["radii"]).sum()),
                loss=[list(map(float, x["loss"])), list(map(float, y["loss"]))],
                stat=stat_diff(x["stat"].ravel(), y["stat"].ravel()))


def add_views(stats: np.ndarray, v: dict) -> np.ndarray:
    """The checkpoint's statistics after `train/densify.py update_stats` of each view."""
    ga, dn, mr = (np.array(s, np.float32) for s in stats)
    for stat, radii in zip(v["stat"], v["radii"]):
        vis = radii > 0
        ga = ga + stat * vis
        dn = dn + vis
        mr = np.maximum(mr, np.where(vis, radii, 0.0))
    return np.stack([ga, dn, mr])


def peak_rss_gb() -> float:
    """This process's peak resident memory so far, in GiB (Linux reports KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def card_part(saved: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in saved.items()
            if k.startswith(prefix) and k != "launches"}


def compare(args) -> None:
    import torch
    p = params_of(args.smoke)
    cks = args.ckpts or checkpoints_of(args.smoke)
    scene = load_scene(os.path.join(args.out, "scene"))
    cams = scene.get_train_cameras()
    card_path = os.path.join(args.out, "card.npz")
    card_saved = read_ckpt(card_path) if os.path.exists(card_path) else {}
    torch.set_num_threads(args.threads)
    path = os.path.join(args.out, "ab.json")
    report = dict(resolution=[cams[0].width, cams[0].height], rel_tol=REL_TOL,
                  significant=SIGNIFICANT, checkpoints={})
    if os.path.exists(path):      # earlier checkpoints' readings stay
        with open(path) as fh:
            report["checkpoints"] = json.load(fh)["checkpoints"]
    for c in cks:
        ck = read_ckpt(os.path.join(args.out, "ckpt", f"chkpnt{c}.npz"))
        vcams = [cams[i] for i in views(c, len(cams))]
        runs, seconds = {}, {}
        for v in args.variants:
            t0 = time.perf_counter()
            if v == "b":
                runs[v] = port_views(ck, vcams, p.budget_factor, "cpu")
            elif v in ("a", "t"):
                jax_setup(v == "t")
                runs[v] = jax_views(ck, vcams, p.budget_factor)
            seconds[v] = time.perf_counter() - t0
        if f"{c}_stat" in card_saved:
            runs["c"] = card_part(card_saved, f"{c}_")
        alive = leaf(ck, "alive").astype(bool)
        size = c >= p.opacity_reset_interval
        dec = {k: decisions(add_views(np.stack([ck[f"stats_{i}"] for i in range(3)]), r),
                            leaf(ck, "opacity")[:, 0], leaf(ck, "scaling"), alive,
                            extent=scene.cameras_extent,
                            grad_threshold=p.densify_grad_threshold,
                            use_size_threshold=size)
               for k, r in runs.items()}
        pairs = [(x, y) for x, y in PAIRS if x in runs and y in runs]
        entry = dict(views=views(c, len(cams)), alive=int(alive.sum()),
                     size_threshold=size, seconds=seconds, peak_rss_gb=peak_rss_gb(),
                     views_compared=[compare_views(x, runs[x], y, runs[y])
                                     for x, y in pairs],
                     decisions={f"{x}-{y}": decision_diff(dec[x], dec[y],
                                                          p.densify_grad_threshold)
                                for x, y in pairs},
                     hot={k: int(d["hot"].sum()) for k, d in dec.items()})
        report["checkpoints"][str(c)] = entry
        print(json.dumps({c: entry}), flush=True)
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1)


def steps(args) -> None:
    import torch
    p = params_of(args.smoke)
    first = checkpoints_of(args.smoke)[0]
    last = first + p.densification_interval
    scene = load_scene(os.path.join(args.out, "scene"))
    cams = scene.get_train_cameras()
    torch.set_num_threads(args.threads)
    ck = read_ckpt(os.path.join(args.out, "ckpt", f"chkpnt{first}.npz"))

    def cam_of(it):
        return cams[schedule_position(len(cams), 0, it - 1)]

    runs, seconds = {}, {}
    for v in args.variants:
        t0 = time.perf_counter()
        if v == "b":
            runs[v] = port_steps(ck, cam_of, last, p.budget_factor, "cpu")
        else:
            jax_setup(v == "t")
            runs[v] = jax_steps(ck, cam_of, last, p.budget_factor)
        seconds[v] = time.perf_counter() - t0
        np.savez_compressed(os.path.join(args.out, f"steps_{v}.npz"),
                            **runs[v])
    old_report = os.path.join(args.out, "steps.json")
    if os.path.exists(old_report):  # keep the seconds of earlier invocations
        with open(old_report) as fh:
            seconds = {**json.load(fh)["seconds"], **seconds}
    for v in ("a", "t", "b"):       # variants of earlier invocations
        path = os.path.join(args.out, f"steps_{v}.npz")
        if v not in runs and os.path.exists(path):
            runs[v] = read_ckpt(path)
    card_path = os.path.join(args.out, "card.npz")
    if os.path.exists(card_path):
        runs["c"] = card_part(read_ckpt(card_path), "steps_")
    dec = {k: decisions(r["stats"], r["opacity"], r["scaling"], r["alive"],
                        extent=scene.cameras_extent,
                        grad_threshold=p.densify_grad_threshold,
                        use_size_threshold=False) for k, r in runs.items()}
    pairs = [(x, y) for x, y in PAIRS if x in runs and y in runs]
    report = dict(resolution=[cams[0].width, cams[0].height], steps=[first, last],
                  seconds=seconds, peak_rss_gb=peak_rss_gb(), hot={k: int(d["hot"].sum()) for k, d in dec.items()},
                  stat={f"{x}-{y}": stat_diff(dec[x]["grads"], dec[y]["grads"])
                        for x, y in pairs},
                  decisions={f"{x}-{y}": decision_diff(dec[x], dec[y],
                                                       p.densify_grad_threshold)
                             for x, y in pairs})
    print(json.dumps(report), flush=True)
    with open(os.path.join(args.out, "steps.json"), "w") as fh:
        json.dump(report, fh, indent=1)


def collect(args) -> None:
    """One report of the readings: each card run's curves.json (--runs name=dir) and the
    CPU half's JSON files in --out."""
    report = {"runs": {}}
    for spec in args.runs:
        name, _, path = spec.partition("=")
        with open(os.path.join(path, "curves.json")) as fh:
            report["runs"][name] = json.load(fh)
    for name in ("tpu_init", "ab", "float64", "steps"):
        path = os.path.join(args.out, f"{name}.json")
        if os.path.exists(path):
            with open(path) as fh:
                report[name] = json.load(fh)
    with open(args.report, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.report}: {sorted(report)}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("card", "compare", "steps", "tpu_init", "float64",
                                     "collect"))
    ap.add_argument("--out", required=True)
    ap.add_argument("--ws", default=os.path.join(REPO, ".quality_ws_ab"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iterations", type=int, default=3100)
    ap.add_argument("--ckpts", type=int, nargs="+", default=None)
    ap.add_argument("--variants", nargs="*", default=["a", "t", "b"])
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--init_ckpt", default="",
                    help="card: train from this field (tpu_init's) instead of the SfM "
                         "points'")
    ap.add_argument("--train_only", action="store_true",
                    help="card: train and write curves.json only")
    ap.add_argument("--views_only", action="store_true",
                    help="card: skip staging and training; read <out>/ckpt, <out>/scene")
    ap.add_argument("--runs", nargs="+", default=[],
                    help="collect: name=dir of each card run (its curves.json)")
    ap.add_argument("--report", default=os.path.join(REPO, "DENSIFY_AB.json"))
    ap.add_argument("--f64_child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    {"card": card, "compare": compare, "steps": steps, "tpu_init": tpu_init,
     "float64": float64, "collect": collect}[args.mode](args)


if __name__ == "__main__":
    main(sys.argv[1:])
