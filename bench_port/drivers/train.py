"""Training steps, closed loop: one step after another on a fixed population.

Each call is `train/trainer.py train_step_rgb` (phase A) or `train_step_feature`
(phase B), with `train/loop.py`'s settings, instance-budget and tile-cap policies, and
its rule for a step that dropped instances: the step is discarded and re-run at the
grown caps (`loop.training`), so a retried step counts once. The views come in the
loop's seeded per-epoch order. Set-up builds the field, optimizer state and statistics
once, sizes the budget from every view's instance count, runs the first
`checked_steps` steps (the ones the reference follows) and the rest of the first
epoch, and keeps the state there as the snapshot. From then on the steps replay the
second epoch from the snapshot, again and again: each replay starts from the same
state, so every step does the same work however many steps came before it, and a
faster program does not train the field further into other work. Set-up replays that
epoch until one replay grows no cap; the window then meets no cap it has not seen, and
counts the re-runs it makes all the same.
"""

from __future__ import annotations

import statistics
import time

import torch

from bench_port import harness, scenes, trace
from bench_port.drivers import program
from bench_port.reference import FLOAT32, Precision
from bench_port.reference import geometry as ref_geometry
from bench_port.reference import train as ref_train
from langsplat_tpu_torch.config import OptimizationConfig
from langsplat_tpu_torch.ops.render import count_instances
from langsplat_tpu_torch.train import trainer
from langsplat_tpu_torch.train.densify import STAT_NAMES, DensifyStats
from langsplat_tpu_torch.train.loop import BudgetPolicy, TmaxPolicy, make_settings

#: the program's statistic name -> the reference's
STAT_OF = dict(zip(STAT_NAMES, ref_train.STAT_LEAVES))
#: the most replays of the epoch set-up makes before it gives up on the caps settling
SETTLE_REPLAYS = 4


def targets(cell, seed: int, views: list[int], device) -> list[dict]:
    """The ground truth of `views`: images (phase A) or feature maps and masks."""
    cfg, mix = cell.config, cell.mix
    if mix["phase"] == "A":
        images = harness.gt_images(seed, cfg["views"], cfg["height"], cfg["width"], device)
        return [dict(image=images[v]) for v in views]
    out = []
    for v in views:
        feats, mask = harness.gt_features(seed, v, cfg["language_channels"],
                                          mix["segments"], mix["valid_share"],
                                          cfg["height"], cfg["width"], device)
        out.append(dict(features=feats, mask=mask))
    return out


class Run:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, mix = cell.config, cell.mix
        self.phase = mix["phase"]
        self.include_feature = self.phase == "B"
        scene = scenes.make(cfg, seed, device)
        self.views = cfg["views"]
        self.cams = program.cameras(scene)
        self.mats = [program.matrices(c, device) for c in self.cams]
        self.targets = targets(cell, seed, list(range(self.views)), device)
        self.extent = scene.extent()
        self.geometry = scene._replace(leaves=None)
        self.field = program.field_of(scene.leaves, self.include_feature)
        del scene
        self.pipe = program.pipeline(cfg)
        self.ocfg = OptimizationConfig(**mix["optimization"])
        self.optimizer = trainer.make_optimizer(self.ocfg, self.extent,
                                                self.include_feature)
        self.opt_state = self.optimizer.init(
            trainer.extract_params(self.field, self.include_feature))
        self.stats = DensifyStats.zeros(self.field.capacity, device)
        self.bg = torch.zeros(3, device=device)
        self.capacity = self.field.capacity
        self.budget = BudgetPolicy(self.pipe, self.capacity)
        self.tmax = TmaxPolicy(self.pipe, self.cams)
        if self.pipe.adaptive_budget:
            # the loop probes one view; here every view of the epoch, so the window
            # starts at the budget the epoch needs
            with torch.no_grad():
                probe = max(count_instances(
                    self.field, make_settings(c, self.pipe, 0, self.include_feature,
                                              self.capacity, budget=BudgetPolicy.GRANULE,
                                              max_tiles=self.tmax.tmax), *m)
                    for c, m in zip(self.cams, self.mats))
            self.budget.resize(self.capacity, probe)
        self.iteration = self.reruns = 0
        self.program = self._checked_steps(mix["checked_steps"])
        while self.iteration < self.views:
            self.step()
        self.snapshot = (self.field, self.opt_state, self.stats)
        for _ in range(SETTLE_REPLAYS):
            reruns = self.reruns
            self.restore()
            for _ in range(self.views):
                self.step()
            if self.reruns == reruns:
                break
        else:
            raise RuntimeError(f"the caps still grew in replay {SETTLE_REPLAYS} of the "
                               f"epoch")
        self.reruns = 0
        program.synchronize(device)

    # -- the program's step -------------------------------------------------------

    def view_of(self, iteration: int) -> int:
        epoch, pos = divmod(iteration, self.views)
        return program.epoch_order(self.seed, epoch, self.views)[pos]

    def step(self) -> int:
        """One training step of the schedule's next view (re-run at grown caps while it
        drops instances); returns the view."""
        v = self.view_of(self.iteration)
        cam, mats, target = self.cams[v], self.mats[v], self.targets[v]
        while True:
            settings = make_settings(cam, self.pipe, self.cell.mix["sh_degree"],
                                     self.include_feature, self.capacity,
                                     budget=self.budget.budget, max_tiles=self.tmax.tmax)
            if self.include_feature:
                out = trainer.train_step_feature(
                    self.field, self.opt_state, self.stats, *mats, target["features"],
                    target["mask"], self.bg, settings=settings, optimizer=self.optimizer)
            else:
                out = trainer.train_step_rgb(
                    self.field, self.opt_state, self.stats, *mats, target["image"],
                    self.bg, settings=settings, optimizer=self.optimizer,
                    lambda_dssim=self.cell.mix["lambda_dssim"])
            dropped, rect = int(out.dropped), int(out.rect_dropped)
            if dropped == 0 and rect == 0:
                break
            grew = rect > 0 and self.tmax.grow()
            grew = (dropped > 0 and self.budget.grow(self.capacity)) or grew
            if not grew:
                raise RuntimeError(f"step {self.iteration} dropped {dropped} instances "
                                   f"and {rect} tile positions at the caps")
            self.reruns += 1
        self.field, self.opt_state, self.stats = out.field, out.opt_state, out.stats
        self.last_loss = out.loss
        self.iteration += 1
        return v

    def restore(self) -> None:
        """Back to the snapshot, the start of the replayed epoch (the program's steps
        leave their inputs as they were, so the snapshot is the state itself)."""
        self.field, self.opt_state, self.stats = self.snapshot
        self.iteration = self.views

    def next_step(self) -> int:
        """The replayed epoch's next step; returns its view."""
        if self.iteration == 2 * self.views:
            self.restore()
        return self.step()

    def _checked_steps(self, steps: int) -> dict:
        """Run the first steps; the program's readings: each step's loss, the first
        gradient's norm a leaf (from Adam's first moment after one step, mu = 0.1 g),
        and the norm of each leaf's change (and of each statistic) after the last."""
        start = trainer.extract_params(self.field, self.include_feature)
        losses, grads = [], None
        for _ in range(steps):
            self.step()
            losses.append(float(self.last_loss))
            if grads is None:
                grads = {k: ref_train.norm(s["mu"]) / (1 - trainer.B1)
                         for k, s in self.opt_state.items()}
        now = trainer.extract_params(self.field, self.include_feature)
        change = {k: ref_train.norm(now[k] - start[k]) for k in start}
        if self.phase == "A":
            change.update({STAT_OF[k]: ref_train.norm(getattr(self.stats, k))
                           for k in STAT_NAMES})
        return dict(losses=losses, grads=grads, change=change,
                    views=[self.view_of(i) for i in range(steps)])

    # -- the window -----------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        program.synchronize(self.device)
        times, t0 = [], time.perf_counter()
        while True:
            t = time.perf_counter()
            self.next_step()
            times.append(time.perf_counter() - t)
            if time.perf_counter() - t0 >= seconds:
                break
        program.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        harness.log_calls("step", times)
        return dict(metrics={"train_step_ms": elapsed / len(times) * 1e3},
                    attempted=len(times), failed=0, reruns=self.reruns)

    def traced(self) -> dict:
        """The first `traced_steps` steps of the replayed epoch, timed without the
        profiler and then under it, with Adam's update (`trainer.Adam.update`) in the
        span `bench.optimizer`."""
        calls = self.cell.mix["traced_steps"]
        views = [self.view_of(self.views + i) for i in range(calls)]
        untraced_s = trace.untraced_seconds(lambda i: self.step(), calls, self.device,
                                            self.restore)
        self.restore()
        self.optimizer.update = trace.spanned("optimizer", self.optimizer.update)
        try:
            reading = trace.profile(lambda i: self.step(), calls, self.device)
        finally:
            del self.optimizer.update
        return dict(reading=dict(reading, untraced_s=untraced_s), views=views,
                    attempted=calls, reruns=self.reruns)

    def work(self, ctx: dict) -> None:
        """The work of each traced step, counted by the reference's blend of its view on
        the field after the window: ctx["work"], one entry a traced step."""
        leaves = program.leaves_of(self.field)
        per_view = {}
        for v in sorted(set(ctx["views"])):
            out = ref_train.render_view(leaves, self._ref_view(v),
                                        sh_degree=self.cell.mix["sh_degree"],
                                        tile_size=self.cell.config["tile_size"],
                                        include_feature=self.include_feature)
            per_view[v] = (out["instances"],) + tuple(out["pairs"])
        cfg = self.cell.config
        trained = sum(p.numel() for p in
                      trainer.extract_params(self.field, self.include_feature).values())
        ctx["work"] = []
        for v in ctx["views"]:
            instances, evaluated, blended = per_view[v]
            ctx["work"].append(dict(
                phase=self.phase, capacity=self.capacity, trained_floats=trained,
                features=cfg["language_channels"], instances=instances,
                evaluated=evaluated, blended=blended, width=cfg["width"],
                height=cfg["height"]))
        ctx["kind"] = "train"

    def release(self) -> None:
        self.field = self.opt_state = self.stats = self.targets = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ---------------------------------------------------------------

    def _ref_view(self, v: int) -> ref_geometry.View:
        g = self.geometry
        rot, t = g.poses[v]
        return ref_geometry.view_of(rot, t, g.fov_x, g.fov_y, g.width, g.height,
                                    self.device)

    def reference(self, pr: Precision = FLOAT32, loss_rows: slice | None = None) -> dict:
        """The reference's readings of the checked steps, from inputs it makes again
        from the seed."""
        scene = scenes.make(self.cell.config, self.seed, self.device)
        views = self.program["views"]
        return ref_train.run_steps(
            self.phase, scene.leaves, [self._ref_view(v) for v in views],
            targets(self.cell, self.seed, views, self.device),
            opt=self.cell.mix["optimization"], extent=scene.extent(),
            sh_degree=self.cell.mix["sh_degree"], tile_size=self.cell.config["tile_size"],
            lambda_dssim=self.cell.mix["lambda_dssim"], pr=pr, loss_rows=loss_rows)

    @staticmethod
    def compare(run: dict, ref: dict) -> dict:
        """loss_gap: the first step's loss gap over the reference's loss (a later step's
        loss carries the round-off of the earlier updates, which Adam's normalized step
        can magnify: PERF.md section 2); grad_gap and change_gap: the worst
        leaf's gap of norms (`harness.norm_gaps`). Leaves whose first reference
        gradient is under a thousandth of the median leaf's are left out."""
        grads = ref["grads"]
        median = statistics.median(grads.values())
        still = {k for k, g in grads.items() if g < 1e-3 * median}
        params = {k: v for k, v in ref["change"].items() if k in grads}
        stats = {k: v for k, v in ref["change"].items() if k not in grads}
        change = harness.norm_gaps(run["change"], params, still)
        if stats:
            change = max(change, harness.norm_gaps(run["change"], stats))
        return dict(loss_gap=harness.gap(run["losses"][0], ref["losses"][0],
                                         abs(ref["losses"][0])),
                    grad_gap=harness.norm_gaps(run["grads"], grads, still),
                    change_gap=change)

    def check(self) -> dict:
        return self.compare(self.program, self.reference())

