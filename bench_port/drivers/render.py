"""Renders, closed loop with one client: `train/loop.py render_full` of one view after
another, each call timed from the call to a synchronize, cycling over the scene's views
in an order drawn from the seed. Set-up builds the field and renders every view once.
The comparison takes, for `checked_views` positions of the order drawn from the seed,
the first render of that view in the window and holds its image, feature image and
final transmittance against the reference's render of the same view.
"""

from __future__ import annotations

import math
import random
import time

import torch

from bench_port import harness, scenes, trace
from bench_port.drivers import program
from bench_port.reference import FLOAT32, Precision
from bench_port.reference import geometry as ref_geometry
from bench_port.reference import train as ref_train
from langsplat_tpu_torch.ops import projection
from langsplat_tpu_torch.ops import render as render_ops
from langsplat_tpu_torch.train.loop import render_full


class Run:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, mix = cell.config, cell.mix
        scene = scenes.make(cfg, seed, device)
        self.views = cfg["views"]
        self.cams = program.cameras(scene)
        self.geometry = scene._replace(leaves=None)
        self.include_feature = mix["include_feature"]
        self.field = program.field_of(scene.leaves, self.include_feature)
        del scene
        self.pipe = program.pipeline(cfg)
        self.sh = mix["sh_degree"]
        rng = random.Random(seed)
        self.order = list(range(self.views))
        rng.shuffle(self.order)
        positions = rng.sample(range(min(self.views, mix["traced_views"])),
                               mix["checked_views"])
        self.checked = {self.order[p] for p in positions}
        self.program: dict[int, dict] = {}   # view -> its first render in the window
        for cam in self.cams:
            self.render(cam)
        program.synchronize(device)

    def render(self, cam) -> dict:
        return render_full(self.field, cam, self.pipe, self.sh, self.include_feature,
                           [0.0, 0.0, 0.0], device=self.device)

    def _call(self, i: int) -> float:
        v = self.order[i % self.views]
        t0 = time.perf_counter()
        out = self.render(self.cams[v])
        program.synchronize(self.device)
        latency = time.perf_counter() - t0
        if v in self.checked and v not in self.program:
            self.program[v] = dict(render=out["render"], t_final=out["final_transmittance"],
                                features=(out["language_feature_image"]
                                          if self.include_feature else None))
        return latency

    def window(self, seconds: float) -> dict:
        latencies, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds or not latencies:
            latencies.append(self._call(len(latencies)))
        elapsed = time.perf_counter() - t0
        harness.log_calls("render", latencies)
        return dict(metrics={"render_views_per_s": len(latencies) / elapsed,
                             "render_ms_p95": harness.percentile(latencies, 95) * 1e3},
                    attempted=len(latencies), failed=len(self.checked - set(self.program)))

    def traced(self) -> dict:
        """The first `traced_views` calls of the window's order, timed without the
        profiler and then under it, with `projection.preprocess` and
        `tiles.bin_gaussians` as `ops/render.py render` calls them in the spans
        `bench.preprocess` and `bench.binning`."""
        calls = self.cell.mix["traced_views"]
        untraced_s = trace.untraced_seconds(self._call, calls, self.device, lambda: None)
        preprocess, binning = projection.preprocess, render_ops.bin_gaussians
        projection.preprocess = trace.spanned("preprocess", preprocess)
        render_ops.bin_gaussians = trace.spanned("binning", binning)
        try:
            reading = trace.profile(self._call, calls, self.device)
        finally:
            projection.preprocess, render_ops.bin_gaussians = preprocess, binning
        views = [self.order[i % self.views] for i in range(calls)]
        return dict(reading=dict(reading, untraced_s=untraced_s), views=views,
                    attempted=calls)

    def _ref_view(self, v: int) -> ref_geometry.View:
        g = self.geometry
        rot, t = g.poses[v]
        return ref_geometry.view_of(rot, t, g.fov_x, g.fov_y, g.width, g.height,
                                    self.device)

    def work(self, ctx: dict) -> None:
        """The work of each traced render, counted by the reference's blend."""
        leaves = program.leaves_of(self.field)
        cfg = self.cell.config
        per_view = {}
        for v in sorted(set(ctx["views"])):
            out = ref_train.render_view(leaves, self._ref_view(v), sh_degree=self.sh,
                                        tile_size=cfg["tile_size"],
                                        include_feature=self.include_feature)
            per_view[v] = (out["instances"],) + tuple(out["pairs"])
        ctx["work"] = [dict(capacity=self.field.capacity,
                            features=cfg["language_channels"] if self.include_feature
                            else 0, instances=per_view[v][0], evaluated=per_view[v][1],
                            blended=per_view[v][2], width=cfg["width"],
                            height=cfg["height"]) for v in ctx["views"]]
        ctx["kind"] = "render"

    def release(self) -> None:
        self.field = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, pr: Precision = FLOAT32) -> dict:
        """The reference's render of each checked view, from the leaves it makes again
        from the seed."""
        leaves = scenes.make(self.cell.config, self.seed, self.device).leaves
        out = {}
        for v in sorted(self.checked):
            r = ref_train.render_view(leaves, self._ref_view(v), sh_degree=self.sh,
                                      tile_size=self.cell.config["tile_size"],
                                      include_feature=self.include_feature, pr=pr)
            out[v] = dict(render=r["render"], t_final=r["t_final"], features=r["features"])
        return out

    @staticmethod
    def compare(run: dict, ref: dict) -> dict:
        """image_gap: the widest absolute gap over every checked view's RGB image,
        feature image and final transmittance; a view the run never rendered fails."""
        worst = 0.0
        for v, r in ref.items():
            if v not in run:
                return dict(image_gap=math.inf)
            for key, value in r.items():
                if value is not None:
                    d = float((run[v][key] - value).abs().max())
                    worst = max(worst, d if math.isfinite(d) else math.inf)
        return dict(image_gap=worst)

    def check(self) -> dict:
        return self.compare(self.program, self.reference())
