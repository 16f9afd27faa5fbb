"""Render-time pieces of the training loop: settings, the instance-budget and tile-cap
policies, and `render_full`, which renders one view at whatever caps it needs.

PyTorch-port counterpart of `make_settings`, `BudgetPolicy`, `TmaxPolicy` and
`render_full` in `langsplat_tpu/train/loop.py`. The training loop itself comes with the
training slice.
"""

from __future__ import annotations

import torch

from langsplat_tpu_torch.device import resolve_device
from langsplat_tpu_torch.ops.render import RenderSettings, render


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
        convert_shs_python=pipe.convert_shs_python,
        compute_cov3d_python=pipe.compute_cov3d_python)


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
def render_full(field, cam, pipe, active_sh_degree, include_feature, bg,
                budget: int = 0, max_tiles: int = 0,
                device: str | torch.device | None = None):
    """Render one view on `device` (None: the CUDA card, raising without one), retrying
    at a doubled instance budget / max_tiles cap until nothing is dropped: eval views
    can touch more tiles than training views, and the 3DGS rasterizer never truncates.
    `field` must already live on that device. Eval renders may grow past the
    training-time policy cap, up to an absolute ceiling."""
    device = resolve_device(device)
    if field.device.type != device.type:
        raise ValueError(f"field is on {field.device}, render device is {device}")
    policy_cap = BudgetPolicy(pipe, field.capacity).cap(field.capacity)
    cap = min(max(policy_cap, 64 * field.capacity), RENDER_BUDGET_CEILING)
    budget = min(budget or policy_cap, cap)
    tmax_policy = TmaxPolicy(pipe, [cam])
    if max_tiles:
        tmax_policy.tmax = min(max_tiles, tmax_policy.grid_cap)
    viewmatrix, projmatrix, campos = (
        torch.as_tensor(m, dtype=torch.float32, device=field.device)
        for m in (cam.world_view_transform, cam.full_proj_transform, cam.camera_center))
    bg = torch.as_tensor(bg, dtype=torch.float32, device=field.device)
    while True:
        settings = make_settings(cam, pipe, active_sh_degree, include_feature,
                                 field.capacity, budget=budget,
                                 max_tiles=tmax_policy.tmax)
        r = render(field, settings, viewmatrix, projmatrix, campos, bg)
        dropped = int(r["instances_dropped"])
        rect = int(r["rect_dropped"])
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
