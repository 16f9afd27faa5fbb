"""The two-phase training loop on one device, and `render_full`.

PyTorch-port counterpart of `langsplat_tpu/train/loop.py`: SH-degree warmup every 1000
iterations, the seeded per-epoch camera schedule, densify/clone/split/prune between
densify_from and densify_until every densification_interval, opacity resets, periodic
test/save/checkpoint, all under the fixed-capacity regime: Adam moment rows are zeroed
for churned slots and the capacity grows geometrically when densification overflows.
A step whose render dropped instances (budget) or tile positions (max_tiles) is
discarded and re-run at grown caps, as the JAX loop does.

With `gui_port`, each iteration first serves the SIBR viewer (`utils/network_gui.py`).
With `cfg.profile_dir`, a `torch.profiler` trace of iterations [profile_from,
profile_from + profile_steps) is written there as a Chrome / TensorBoard trace JSON,
with the port's spans (`utils/tracing.py`) as `langsplat.*` annotations: `iteration`
(the root; its call id is the iteration number) holding `train_step` (and its layers,
`train/trainer.py`), the step's host reads (`sync.step.*`), `densify`, `prefetch_wait`,
`evaluate` and `save`.
The JAX loop's multi-device branches (data-parallel with ZeRO-2, Gaussian-sharded with
shard-local densification, depth-sharded phase B) run inside a process group, one
process per rank (`parallel/launch.py`, `parallel/layout.py`).
"""

from __future__ import annotations

import os
import random
from dataclasses import replace

import numpy as np
import torch

from langsplat_tpu_torch.config import TrainConfig, save_config
from langsplat_tpu_torch.core import losses as loss_lib
from langsplat_tpu_torch.data.prefetch import FeaturePrefetcher
from langsplat_tpu_torch.data.scene import Scene
from langsplat_tpu_torch.device import resolve_device
from langsplat_tpu_torch.models import field_io
from langsplat_tpu_torch.ops import _build
from langsplat_tpu_torch.ops.render import RenderSettings, count_instances, render
from langsplat_tpu_torch.parallel import collectives as col
from langsplat_tpu_torch.parallel.data_parallel import dp_train_step
from langsplat_tpu_torch.parallel.depth_sharded import depth_feature_step
from langsplat_tpu_torch.parallel.gauss_densify import sharded_densify
from langsplat_tpu_torch.parallel.gauss_sharded import gauss_train_step
from langsplat_tpu_torch.parallel.layout import Layout
from langsplat_tpu_torch.train import densify as dn
from langsplat_tpu_torch.train import trainer as tr
from langsplat_tpu_torch.utils import tracing
from langsplat_tpu_torch.utils.logging import RunLogger, Timer


def make_settings(cam, pipe, active_sh_degree: int, include_feature: bool,
                  capacity: int, budget: int = 0,
                  max_tiles: int | None = None) -> RenderSettings:
    return RenderSettings(
        image_height=cam.height, image_width=cam.width,
        tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        sh_degree=active_sh_degree, include_feature=include_feature,
        tile_size=pipe.tile_size,
        budget=budget or pipe.budget_factor * capacity,
        max_tiles_per_gaussian=max_tiles or pipe.max_tiles_per_gaussian,
        backend="tiled" if pipe.interpret else "cuda",
        convert_shs_python=pipe.convert_shs_python,
        compute_cov3d_python=pipe.compute_cov3d_python,
        # the feature phase freezes geometry: the backward then only needs
        # d(language_feature), which skips the geometric gradient chain in the kernel
        grad_mode="feature" if include_feature else "full")


class BudgetPolicy:
    """Adaptive instance-budget sizing: start from a probed per-view count times
    headroom, grow geometrically whenever a render reports dropped instances, and cap
    at budget_factor * capacity. A render that dropped is re-run: the 3DGS rasterizer
    never truncates, so neither does this one.

    The second cap, `max_tiles_per_gaussian`, is `TmaxPolicy`'s: a Gaussian whose
    clipped tile rect exceeds it reports `rect_dropped` positions that no budget can
    recover, so the two caps grow independently.
    """

    GRANULE = 4096

    def __init__(self, pipe, capacity: int):
        self.pipe = pipe
        self._budget = 0
        self.resize(capacity)

    def _round(self, x: float) -> int:
        return max(int(-(-x // self.GRANULE)) * self.GRANULE, self.GRANULE)

    @property
    def budget(self) -> int:
        return self._budget

    def cap(self, capacity: int) -> int:
        return self._round(self.pipe.budget_factor * capacity)

    def resize(self, capacity: int, probe_count: int | None = None) -> None:
        if not self.pipe.adaptive_budget:
            self._budget = self.cap(capacity)
            return
        if probe_count is not None:
            want = self._round(probe_count * self.pipe.budget_headroom)
            self._budget = min(max(self._budget, want), self.cap(capacity))
        elif self._budget == 0:
            self._budget = min(self._round(capacity), self.cap(capacity))

    def grow(self, capacity: int) -> bool:
        """Geometric growth after an overflow; False if already at the cap."""
        if not self.pipe.adaptive_budget:
            return False
        new = min(self._round(self._budget * 1.5), self.cap(capacity))
        if new == self._budget:
            return False
        self._budget = new
        return True


class TmaxPolicy:
    """Adaptive `max_tiles_per_gaussian`: doubled whenever a render reports
    `rect_dropped` tile positions, capped at the largest tile grid any camera uses (then
    every clipped rect fits). Past tiles.MAX_CULL_TMAX the tile cull is off (correct,
    just more instances)."""

    def __init__(self, pipe, cameras):
        self.tmax = pipe.max_tiles_per_gaussian
        ts = pipe.tile_size
        self.grid_cap = max((-(-c.width // ts)) * (-(-c.height // ts))
                            for c in cameras) if cameras else pipe.tile_size ** 2

    def grow(self) -> bool:
        new = min(self.tmax * 2, self.grid_cap)
        if new <= self.tmax:
            return False
        self.tmax = new
        return True


#: absolute instance ceiling for eval renders (~16.7M instances)
RENDER_BUDGET_CEILING = 1 << 24


@torch.no_grad()
@tracing.traced("render_full")
def render_full(field, cam, pipe, active_sh_degree, include_feature, bg,
                budget: int = 0, max_tiles: int = 0,
                device: str | torch.device | None = None):
    """Render one view on `device` (None: the CUDA card, raising without one), retrying
    at a doubled instance budget / max_tiles cap until nothing is dropped: eval views
    can touch more tiles than training views, and the 3DGS rasterizer never truncates.
    `field` must already live on that device. Eval renders may grow past the
    training-time policy cap, up to an absolute ceiling.

    Counted in `render_calls` and, each try, `render_attempts`; spans: `render_full`,
    the camera's copy to the device (`sync.render_full.*`) and one `attempt` a try,
    which holds `render` and the read of its drop counters."""
    device = resolve_device(device)
    if field.device.type != device.type:
        raise ValueError(f"field is on {field.device}, render device is {device}")
    policy_cap = BudgetPolicy(pipe, field.capacity).cap(field.capacity)
    cap = min(max(policy_cap, 64 * field.capacity), RENDER_BUDGET_CEILING)
    budget = min(budget or policy_cap, cap)
    tmax_policy = TmaxPolicy(pipe, [cam])
    if max_tiles:
        tmax_policy.tmax = min(max_tiles, tmax_policy.grid_cap)
    tracing.COUNTERS["render_calls"] += 1
    viewmatrix, projmatrix, campos = (
        tracing.upload("render_full.camera", m, dtype=torch.float32, device=field.device)
        for m in (cam.world_view_transform, cam.full_proj_transform, cam.camera_center))
    bg = (torch.as_tensor(bg, dtype=torch.float32, device=field.device)
          if isinstance(bg, torch.Tensor) else
          tracing.upload("render_full.bg", bg, dtype=torch.float32, device=field.device))
    while True:
        tracing.COUNTERS["render_attempts"] += 1
        with tracing.span("attempt"):
            settings = make_settings(cam, pipe, active_sh_degree, include_feature,
                                     field.capacity, budget=budget,
                                     max_tiles=tmax_policy.tmax)
            r = render(field, settings, viewmatrix, projmatrix, campos, bg)
            dropped = tracing.host_read("render_full.dropped", r["instances_dropped"])
            rect = tracing.host_read("render_full.rect_dropped", r["rect_dropped"])
        if dropped == 0 and rect == 0:
            return r
        grew = False
        if rect > 0 and tmax_policy.grow():
            grew = True
        if dropped > 0 and budget < cap:
            budget = min(budget * 2, cap)
            grew = True
        if not grew:
            if pipe.allow_budget_truncation:
                return r
            raise RuntimeError(
                f"render dropped {dropped} instances at the budget cap {cap} "
                f"+ {rect} rect positions at max_tiles={tmax_policy.tmax} "
                f"(capacity {field.capacity}); raise pipeline.budget_factor or "
                f"opt into truncation with pipeline.allow_budget_truncation")


def _device_image(cam, device):
    """The camera's ground-truth image on `device`, copied once and kept on the camera."""
    img = getattr(cam, "_dev_image", None)
    if img is None or img.device != device:
        img = tracing.upload("gt_image", cam.image, device=device)
        cam._dev_image = img
    return img


def _camera_tensors(cam, device):
    return tuple(tracing.upload("camera", m, dtype=torch.float32, device=device)
                 for m in (cam.world_view_transform, cam.full_proj_transform,
                           cam.camera_center))


class TraceWindow:
    """A `torch.profiler` trace over a window of training iterations: CPU activity, and
    the card's with a CUDA device; no shapes or stacks (a step makes ~10^4 host
    events). The window is one tracing session (`utils/tracing.py`): the trace holds
    the port's `langsplat.*` spans. `stop` writes the Chrome / TensorBoard trace JSON
    and returns where it went, with the session's counter increments (`counters`) and,
    of them, the kernel launches (`launches`)."""

    def __init__(self, device: torch.device, first: int):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.device, self.first = device, first
        tracing.end_session()
        self.profiler = profile(activities=activities)
        self.profiler.start()

    def stop(self, profile_dir: str, end: int) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"iterations_{self.first}_{end}.pt.trace.json")
        self.profiler.export_chrome_trace(path)
        counts = tracing.session().counts
        return {"path": path, "iterations": (self.first, end), "counters": counts,
                "launches": {k: counts.get(f"launches.{k}", 0) for k in _build.LAUNCHES}}

    def close(self) -> None:
        """Stop the trace without writing it (the window did not end)."""
        self.profiler.stop()


def _views(cams, device):
    """The camera matrices of a list of cameras: (views, projections, centers) lists."""
    mats = [_camera_tensors(c, device) for c in cams]
    return [m[0] for m in mats], [m[1] for m in mats], [m[2] for m in mats]


def _state_hashes(layout, field, opt_state, stats) -> list[str]:
    """Every rank's hash of the state its layout replicates; raises if they differ."""
    hashes = col.gather_object(layout.replicated_hash(field, opt_state, stats),
                               layout.group)
    if len(set(hashes)) != 1:
        raise RuntimeError(f"the replicated training state differs across ranks: "
                           f"{hashes}")
    return hashes


def training(cfg: TrainConfig, device: str | torch.device | None = None,
             gui_host: str = "127.0.0.1", gui_port: int = 0,
             gui_wait: float = 0.0) -> dict:
    """Train one phase on `device` (None: the CUDA card, raising without one), serving
    the viewer on gui_host:gui_port when gui_port is set; with gui_wait, the first step
    waits up to that many seconds for the viewer to connect. Returns the final field,
    optimizer state, statistics (full capacity, gathered), scene, loss history, active
    SH degree, the profiler trace (`TraceWindow.stop`'s record, None without one) and
    `parallel`: this rank's layout, step times, collective times, peak memory, kernel
    launches and the replicated state's hashes.

    Inside a process group (`parallel/launch.py`), this is one rank of a multi-device
    run (`parallel/layout.py`): every rank runs this loop; rank 0 alone writes the
    configuration, PLY files, checkpoints, log, trace and serves the viewer."""
    device = resolve_device(device)
    mcfg, ocfg, pipe = cfg.model, cfg.optimization, cfg.pipeline
    include_feature = ocfg.include_feature
    layout = Layout.from_config(pipe, include_feature, device)
    main = layout.is_main
    logger = RunLogger(mcfg.model_path if main else None, quiet=cfg.quiet or not main)

    scene = Scene(mcfg if main else replace(mcfg, model_path=""), device=device,
                  initial_capacity_factor=ocfg.initial_capacity_factor, seed=cfg.seed,
                  create_field=not cfg.start_checkpoint)
    field = scene.gaussians
    spatial_lr_scale = scene.cameras_extent
    active_sh_degree = 0
    first_iter = 0

    if include_feature and not cfg.start_checkpoint:
        raise ValueError("feature training requires a phase-A checkpoint "
                         "(--start_checkpoint)")

    resume_full = False
    if cfg.start_checkpoint:
        field, first_iter, spatial_lr_scale, active_sh_degree, ck_has_feature = \
            field_io.load_field(cfg.start_checkpoint, device=device)
        # a same-phase checkpoint with optimizer and statistics groups resumes the
        # whole training state; a cross-phase one restores the field only
        resume_full = (ck_has_feature == include_feature
                       and field_io.checkpoint_has_state(cfg.start_checkpoint))
        if include_feature and not ck_has_feature:
            first_iter = 0   # the phase handoff restarts the iteration count
    if include_feature:
        field = field.with_language_feature(
            3, generator=torch.Generator().manual_seed(cfg.seed))

    optimizer = tr.make_optimizer(ocfg, spatial_lr_scale, include_feature)
    opt_state = optimizer.init(tr.extract_params(field, include_feature))
    stats = dn.DensifyStats.zeros(field.capacity, device)
    if resume_full:
        field, opt_state, stats, first_iter, spatial_lr_scale, active_sh_degree = \
            field_io.load_checkpoint(cfg.start_checkpoint, device=device)
        logger.log(f"resumed full training state at iteration {first_iter} "
                   f"(capacity {field.capacity})")

    if mcfg.model_path and main:
        save_config(cfg, os.path.join(mcfg.model_path, "cfg_args.json"))

    bg = torch.tensor([1.0, 1.0, 1.0] if mcfg.white_background else [0.0, 0.0, 0.0],
                      device=device)
    budget_policy = BudgetPolicy(pipe, field.capacity)
    tmax_policy = TmaxPolicy(pipe, scene.get_train_cameras() + scene.get_test_cameras())
    if pipe.adaptive_budget:
        probe_cam = scene.get_train_cameras()[0]
        probe_settings = make_settings(probe_cam, pipe, 0, include_feature,
                                       field.capacity, budget=BudgetPolicy.GRANULE,
                                       max_tiles=tmax_policy.tmax)
        with torch.no_grad():
            cnt = count_instances(field, probe_settings,
                                  *_camera_tensors(probe_cam, device))
        budget_policy.resize(field.capacity, cnt)
        logger.log(f"instance budget {budget_policy.budget} "
                   f"(probed {cnt}, cap {budget_policy.cap(field.capacity)})")

    # the full state is identical on every rank here; lay it out over the ranks
    field, opt_state, stats = layout.setup(field, opt_state, stats)
    capacity = layout.capacity(field)
    if layout.kind is not None:
        logger.log(f"{layout.kind}-parallel over {layout.world} rank(s) "
                   f"({col.backend(layout.group)}), capacity {capacity}"
                   + (", ZeRO-2 optimizer rows" if layout.zero2 else ""))

    # per-epoch camera order, a pure function of (seed, epoch), so a resumed run sees
    # the view sequence an uninterrupted run would (the JAX package's schedule)
    train_cams = scene.get_train_cameras()
    cur_epoch, epoch_order = -1, []

    def schedule_cam(idx: int):
        nonlocal cur_epoch, epoch_order
        epoch, pos = divmod(idx, len(train_cams))
        if epoch != cur_epoch:
            epoch_order = list(range(len(train_cams)))
            random.Random(cfg.seed * 1_000_003 + epoch).shuffle(epoch_order)
            cur_epoch = epoch
        return train_cams[epoch_order[pos]], pos

    # data-parallel batches: iteration i takes schedule positions
    # [(i-1) B, i B), B = world * views a rank, and rank r the r-th slice of them
    dp_batch = layout.world * layout.views_per_rank

    def rank_cams(iteration: int) -> list:
        first = (iteration - 1) * dp_batch + layout.rank * layout.views_per_rank
        return [schedule_cam(first + j)[0] for j in range(layout.views_per_rank)]

    timer = Timer(device)
    history: list[float] = []
    step_ms: list[float] = []
    prefetcher = (FeaturePrefetcher(mcfg.lf_path, mcfg.feature_level, device=device)
                  if include_feature else None)

    def gui_render(view_field, minicam, scale_mod):
        settings = RenderSettings(
            image_height=minicam.height, image_width=minicam.width,
            tanfovx=minicam.tanfovx, tanfovy=minicam.tanfovy,
            sh_degree=active_sh_degree, include_feature=False,
            scale_modifier=float(scale_mod), tile_size=pipe.tile_size,
            budget=pipe.budget_factor * view_field.capacity,
            backend="tiled" if pipe.interpret else "cuda")
        with torch.no_grad():
            return render(view_field, settings, *_camera_tensors(minicam, device),
                          bg)["render"]

    gui = None
    if gui_port and main:
        from langsplat_tpu_torch.utils.network_gui import NetworkGUI
        gui = NetworkGUI()
        try:
            gui.init(gui_host, gui_port)
            if gui_wait:
                gui.try_connect(gui_wait)
        except OSError as e:
            logger.log(f"network GUI disabled ({e})")
            gui.close()
            gui = None

    col.reset()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window, trace = None, None
    try:
        for iteration in range(first_iter + 1, ocfg.iterations + 1):
            if cfg.profile_dir and main:
                if iteration == cfg.profile_from:
                    window = TraceWindow(device, iteration)
                elif (window is not None
                      and iteration == cfg.profile_from + cfg.profile_steps):
                    trace = window.stop(cfg.profile_dir, iteration)
                    window = None
                    logger.log(f"profiler trace ({cfg.profile_steps} steps) written to "
                               f"{trace['path']}")
            with tracing.span("iteration", call=iteration):
                if gui_port:
                    view_field = field
                    if layout.kind == "gauss":
                        # the viewer renders the whole field, which no rank holds:
                        # gather it for every frame of an iteration a viewer is
                        # connected in
                        if gui is not None and gui.conn is None:
                            gui.try_connect()
                        connected = col.max_(torch.tensor(
                            [int(gui is not None and gui.conn is not None)],
                            device=device))
                        view_field = (layout.full_field(field) if int(connected[0])
                                      else None)
                    if gui is not None:
                        gui.poll(lambda c, s: gui_render(view_field, c, s),
                                 mcfg.source_path, iteration, ocfg.iterations)

                if iteration % 1000 == 0 and active_sh_degree < mcfg.sh_degree:
                    active_sh_degree += 1

                if layout.kind == "data":
                    batch = [schedule_cam((iteration - 1) * dp_batch + j)[0]
                             for j in range(dp_batch)]
                    cam = batch[0]
                    for c in batch[1:]:
                        if (c.height, c.width) != (cam.height, cam.width):
                            raise ValueError(
                                "data-parallel training requires uniform image sizes "
                                f"across the view batch, got {c.height}x{c.width} vs "
                                f"{cam.height}x{cam.width}")
                    mine = rank_cams(iteration)
                    if prefetcher is not None:
                        for c in mine + rank_cams(iteration + 1):
                            prefetcher.schedule(c)
                    views = _views(mine, device)
                else:
                    cam, epoch_pos = schedule_cam(iteration - 1)
                    if prefetcher is not None and epoch_pos + 1 < len(train_cams):
                        prefetcher.schedule(train_cams[epoch_order[epoch_pos + 1]])
                    mine = [cam]
                    views = _views(mine, device)

                def targets():
                    if include_feature:
                        fm = [prefetcher.get(c) for c in mine]
                        return [f for f, _ in fm], [m for _, m in fm]
                    return ([_device_image(c, device) for c in mine],
                            [torch.ones((1, 1, 1), device=device)] * len(mine))

                timer.start()
                while True:
                    settings = make_settings(cam, pipe, active_sh_degree,
                                             include_feature, capacity,
                                             budget=budget_policy.budget,
                                             max_tiles=tmax_policy.tmax)
                    step_kw = dict(settings=settings, optimizer=optimizer,
                                   include_feature=include_feature,
                                   lambda_dssim=ocfg.lambda_dssim)
                    if layout.kind == "data":
                        o = dp_train_step(field, opt_state, stats, *views, *targets(),
                                          bg, group=layout.group, zero2=layout.zero2,
                                          **step_kw)
                        out = tr.StepOutput(o.field, o.opt_state, o.stats, o.loss, o.loss,
                                            torch.zeros(()), o.dropped, o.rect_dropped)
                    elif layout.kind == "gauss":
                        o = gauss_train_step(field, opt_state, stats, *views,
                                             *targets(), bg, capacity=capacity,
                                             gauss_group=layout.group, **step_kw)
                        out = tr.StepOutput(o.field, o.opt_state, o.stats, o.loss, o.loss,
                                            torch.zeros(()), o.dropped, o.rect_dropped)
                    elif layout.kind == "depth":
                        gt_feat, gt_mask = prefetcher.get(cam)
                        nf, no, dloss, ddrop, drect = depth_feature_step(
                            field, opt_state, *(m[0] for m in views), gt_feat, gt_mask,
                            bg, settings=settings, optimizer=optimizer,
                            group=layout.group)
                        out = tr.StepOutput(nf, no, stats, dloss, dloss, torch.zeros(()),
                                            ddrop, drect)
                    elif include_feature:
                        gt_feat, gt_mask = prefetcher.get(cam)
                        out = tr.train_step_feature(field, opt_state, stats,
                                                    *(m[0] for m in views), gt_feat,
                                                    gt_mask, bg, settings=settings,
                                                    optimizer=optimizer)
                    else:
                        out = tr.train_step_rgb(field, opt_state, stats,
                                                *(m[0] for m in views),
                                                _device_image(cam, device), bg,
                                                settings=settings, optimizer=optimizer,
                                                lambda_dssim=ocfg.lambda_dssim)
                    # multi-device steps report the group's summed counts, so every
                    # rank decides to retry alike
                    dropped = tracing.host_read("step.dropped", out.dropped)
                    rect = tracing.host_read("step.rect_dropped", out.rect_dropped)
                    if dropped == 0 and rect == 0:
                        break
                    # discard the truncated step (field, opt_state and stats are still
                    # the values before it) and re-run it at the grown cap(s)
                    grew = False
                    if rect > 0 and tmax_policy.grow():
                        logger.log(f"[iter {iteration}] max_tiles_per_gaussian -> "
                                   f"{tmax_policy.tmax} ({rect} rect positions dropped)")
                        grew = True
                    if dropped > 0 and budget_policy.grow(capacity):
                        logger.log(f"[iter {iteration}] instance budget -> "
                                   f"{budget_policy.budget} ({dropped} dropped)")
                        grew = True
                    if not grew:
                        msg = (f"[iter {iteration}] {dropped} instances dropped at the "
                               f"budget cap {budget_policy.cap(capacity)} and {rect} "
                               f"rect positions dropped at max_tiles={tmax_policy.tmax} "
                               f"(capacity {capacity}, budget_factor "
                               f"{pipe.budget_factor}); raise pipeline.budget_factor, "
                               f"or opt into truncation with "
                               f"pipeline.allow_budget_truncation")
                        if not pipe.allow_budget_truncation:
                            raise RuntimeError(msg)
                        logger.log("WARNING (truncated step): " + msg)
                        break
                    tracing.COUNTERS["step_reruns"] += 1
                field, opt_state, stats = out.field, out.opt_state, out.stats
                elapsed = timer.stop()
                step_ms.append(elapsed)

                loss_val = tracing.host_read("step.loss", out.loss)
                if pipe.debug:
                    logger.log(f"[iter {iteration}] debug: budget={budget_policy.budget} "
                               f"cap={budget_policy.cap(capacity)} dropped={dropped} "
                               f"alive={field.num_alive}/{field.capacity} (this rank)")
                history.append(loss_val)
                logger.progress(iteration, loss_val,
                                extra=f" n={field.num_alive} {elapsed:.0f}ms")
                logger.scalar("train_loss_patches/l1_loss",
                              tracing.host_read("step.l1", out.l1), iteration)
                logger.scalar("train_loss_patches/total_loss", loss_val, iteration)
                logger.scalar("iter_time", elapsed, iteration)

                # densification (phase A only)
                with tracing.span("densify"):
                    if not include_feature and iteration < ocfg.densify_until_iter:
                        if (iteration > ocfg.densify_from_iter
                                and iteration % ocfg.densification_interval == 0):
                            # the split noise is a pure function of (seed, iteration), so
                            # a resumed run, and every rank, draws what an uninterrupted
                            # run would
                            gen = torch.Generator(device).manual_seed(
                                cfg.seed * 1_000_003 + iteration)
                            rule = dict(
                                extent=scene.cameras_extent,
                                grad_threshold=ocfg.densify_grad_threshold,
                                percent_dense=ocfg.percent_dense, min_opacity=0.005,
                                use_size_threshold=(iteration
                                                    > ocfg.opacity_reset_interval),
                                size_threshold=20.0)
                            if layout.kind == "gauss":
                                # shard-local slots, serial-equal decisions
                                noise = torch.randn((capacity, 2, 3), generator=gen,
                                                    dtype=field.xyz.dtype, device=device)
                                res = sharded_densify(field, stats, noise,
                                                      group=layout.group, **rule)
                            else:
                                res = dn.densify_and_prune(field, stats, gen, **rule)
                            field, stats = res.field, res.stats
                            opt_state = tr.zero_moment_rows(
                                opt_state, layout.local_mask(res.reset_mask))
                            overflow = tracing.host_read("densify.overflow", res.overflow)
                            if overflow > 0:
                                new_cap = layout.round_capacity(
                                    int(capacity * ocfg.capacity_growth_factor))
                                logger.log(f"[iter {iteration}] capacity {capacity} -> "
                                           f"{new_cap} (overflow {overflow})")
                                field, opt_state, stats = layout.grow(field, opt_state,
                                                                      new_cap)
                                capacity = new_cap
                            logger.scalar("total_points", tracing.host_read(
                                "densify.num_alive", res.num_alive), iteration)

                        if iteration % ocfg.opacity_reset_interval == 0 or (
                                mcfg.white_background
                                and iteration == ocfg.densify_from_iter):
                            field = dn.reset_opacity(field)
                            rows = opt_state["opacity"]["mu"].shape[0]
                            opt_state = tr.zero_moment_rows(
                                opt_state,
                                torch.ones(rows, dtype=torch.bool, device=device),
                                only_label="opacity")

                saving = (iteration in cfg.test_iterations
                          or (iteration in cfg.save_iterations and mcfg.model_path)
                          or (iteration in cfg.checkpoint_iterations and mcfg.model_path))
                if saving:
                    # every rank joins the gather; rank 0 reports and writes, the others
                    # wait for it at the barrier
                    full_field, full_opt, full_stats = layout.full(field, opt_state,
                                                                   stats)
                if saving and main:
                    if iteration in cfg.test_iterations:
                        with tracing.span("evaluate"):
                            report = evaluate_psnr(
                                full_field, scene, pipe, active_sh_degree,
                                include_feature, bg, budget=budget_policy.budget,
                                max_tiles=tmax_policy.tmax,
                                lf_path=mcfg.lf_path if include_feature else None,
                                feature_level=mcfg.feature_level)
                        for name, rep in report.items():
                            logger.log(f"[ITER {iteration}] Evaluating {name}: L1 "
                                       f"{rep['l1']:.5f} PSNR {rep['psnr']:.3f}")
                            logger.scalar(f"{name}/loss_viewpoint - l1_loss", rep["l1"],
                                          iteration)
                            logger.scalar(f"{name}/loss_viewpoint - psnr", rep["psnr"],
                                          iteration)
                            if rep.get("feature_l1") is not None:
                                logger.log(f"[ITER {iteration}] Evaluating {name}: "
                                           f"feature-L1 {rep['feature_l1']:.5f}")
                                logger.scalar(f"{name}/loss_viewpoint - feature_l1",
                                              rep["feature_l1"], iteration)

                    if iteration in cfg.save_iterations and mcfg.model_path:
                        logger.log(f"[ITER {iteration}] Saving Gaussians")
                        with tracing.span("save"):
                            scene.save(iteration, full_field)

                    if iteration in cfg.checkpoint_iterations and mcfg.model_path:
                        logger.log(f"[ITER {iteration}] Saving Checkpoint")
                        with tracing.span("save"):
                            field_io.save_checkpoint(
                                os.path.join(mcfg.model_path, f"chkpnt{iteration}.npz"),
                                full_field, full_opt, full_stats, iteration,
                                spatial_lr_scale, active_sh_degree)
                if saving:
                    del full_field, full_opt, full_stats
                    col.barrier(layout.group)

        if window is not None:    # the loop ended inside the window
            trace = window.stop(cfg.profile_dir, ocfg.iterations + 1)
            window = None
            logger.log(f"profiler trace (to the last step) written to {trace['path']}")
    finally:    # also when a step or the viewer's render raises
        if window is not None:
            window.close()
        if gui is not None:
            gui.close()
        if prefetcher is not None:
            prefetcher.close()
        logger.close()
    hashes = _state_hashes(layout, field, opt_state, stats)
    collective_ms = col.timings()
    field, opt_state, stats = layout.full(field, opt_state, stats)
    info = dict(kind=layout.kind, world=layout.world, rank=layout.rank,
                backend=col.backend(layout.group), device=str(device),
                step_ms=step_ms, collectives=collective_ms,
                peak_memory_bytes=(torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else None),
                launches=dict(_build.LAUNCHES), state_hashes=hashes)
    return {"field": field, "opt_state": opt_state, "stats": stats, "scene": scene,
            "history": history, "active_sh_degree": active_sh_degree, "trace": trace,
            "parallel": info}


@torch.no_grad()
def evaluate_psnr(field, scene: Scene, pipe, active_sh_degree, include_feature, bg,
                  max_train_views: int = 5, budget: int = 0, max_tiles: int = 0,
                  lf_path: str | None = None, feature_level: int = 0) -> dict:
    """Test-time L1/PSNR of the RGB render over the test views and the first training
    views; in the feature phase with `lf_path`, also the masked feature L1."""
    device = field.device
    out = {}
    for name, cams in (("test", scene.get_test_cameras()),
                       ("train", scene.get_train_cameras()[:max_train_views])):
        if not cams:
            continue
        l1s, psnrs, feat_l1s = [], [], []
        for cam in cams:
            r = render_full(field, cam, pipe, active_sh_degree, include_feature, bg,
                            budget=budget, max_tiles=max_tiles, device=device)
            img = torch.clamp(r["render"], 0, 1)
            gt = torch.clamp(_device_image(cam, device), 0, 1)
            l1s.append(tracing.host_read("eval.l1", loss_lib.l1_loss(img, gt)))
            psnrs.append(tracing.host_read("eval.psnr", loss_lib.psnr(img, gt)))
            if include_feature and lf_path:
                gt_feat, gt_mask = cam.get_language_feature(lf_path, feature_level)
                feat_l1 = loss_lib.masked_l1_loss(
                    r["language_feature_image"],
                    tracing.upload("eval.feature", gt_feat, device=device),
                    tracing.upload("eval.mask", gt_mask, device=device))
                feat_l1s.append(tracing.host_read("eval.feature_l1", feat_l1))
        out[name] = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs)),
                     "feature_l1": float(np.mean(feat_l1s)) if feat_l1s else None}
    return out
