"""Where the training state lives across the ranks of a multi-device run, and every
decision of the training loop that depends on it: setup, the step, the cameras a rank
renders, densification, capacity growth, gathering for a save or the viewer.

One `Layout` per run, from the pipeline options (the JAX loop's `data_mesh`,
`gauss_mesh` and `depth_mesh` branches, `langsplat_tpu/train/loop.py:263-382`):
  - "data" (--data_shards): field, statistics and optimizer state replicated; with
    --zero2 the Adam moments split by rows (`data_parallel.shard_opt_state`), the
    capacity a multiple of the world size;
  - "gauss" (--gauss_shards): field, optimizer state and statistics split by rows after
    the round-robin `spread_rows`, the capacity a multiple of the world size;
  - "depth" (--depth_shards, phase B): everything replicated;
  - None: one process.
Replicated state stays bit-equal across ranks: every rank takes the same steps with the
same all-reduced values and densifies with the same noise; `replicated_hash` lets the
loop check it.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

from langsplat_tpu_torch.models.gaussian_field import grow_capacity
from langsplat_tpu_torch.parallel import collectives as col
from langsplat_tpu_torch.parallel import data_parallel as dp
from langsplat_tpu_torch.parallel import gauss_sharded as gs
from langsplat_tpu_torch.parallel import mesh as mesh_lib
from langsplat_tpu_torch.parallel.depth_sharded import depth_feature_step
from langsplat_tpu_torch.parallel.gauss_densify import sharded_densify
from langsplat_tpu_torch.train import densify as dn
from langsplat_tpu_torch.train import trainer as tr


def parallel_kind(pipe, include_feature: bool) -> str | None:
    """The run's layout kind from the pipeline options, with the JAX loop's exclusions
    (`langsplat_tpu/train/loop.py:293-296, 334-337`)."""
    if pipe.gauss_shards > 1:
        if pipe.data_shards > 1 or pipe.depth_shards > 1:
            raise ValueError("--gauss_shards cannot be combined with --data_shards or "
                             "--depth_shards; pick one parallelism axis per run")
        return "gauss"
    if pipe.data_shards > 1 and include_feature and pipe.depth_shards > 1:
        raise ValueError("--data_shards and --depth_shards cannot be combined in the "
                         "feature phase; pick view parallelism or depth parallelism")
    if pipe.data_shards >= 1 and pipe.data_shards * max(pipe.dp_views_per_device, 1) > 1:
        return "data"
    if include_feature and pipe.depth_shards > 1:
        return "depth"
    return None


def world_size(pipe, include_feature: bool) -> int:
    """The number of ranks (processes) the run needs."""
    kind = parallel_kind(pipe, include_feature)
    return {"gauss": pipe.gauss_shards, "data": max(pipe.data_shards, 1),
            "depth": pipe.depth_shards}.get(kind, 1)


def _hash(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@dataclass
class Layout:
    kind: str | None
    world: int
    rank: int
    zero2: bool
    views_per_rank: int
    mesh: object = None

    @staticmethod
    def from_config(pipe, include_feature: bool, device: torch.device) -> "Layout":
        kind = parallel_kind(pipe, include_feature)
        world = world_size(pipe, include_feature)
        if col.size() != world:
            raise RuntimeError(f"this run needs {world} rank(s); the process group has "
                               f"{col.size()} (parallel/launch.py starts them)")
        axis = {"data": "data", "gauss": "gauss", "depth": "depth"}.get(kind, "data")
        mesh = mesh_lib.make_mesh(world, (axis,), device.type) if world > 1 else None
        return Layout(kind=kind, world=world, rank=col.rank(), mesh=mesh,
                      zero2=kind == "data" and pipe.zero2,
                      views_per_rank=max(pipe.dp_views_per_device, 1)
                      if kind == "data" else 1)

    @property
    def group(self):
        return None if self.mesh is None else self.mesh.get_group(self.mesh.mesh_dim_names[0])

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def split_rows(self) -> bool:
        """Whether capacities must divide by the world size."""
        return self.zero2 or self.kind == "gauss"

    def round_capacity(self, capacity: int) -> int:
        return -(-capacity // self.world) * self.world if self.split_rows else capacity

    def setup(self, field, opt_state, stats):
        """Lay the full (every rank's identical) state out: round the capacity up, then
        split the moments (ZeRO-2) or spread and split every row (gauss)."""
        cap = field.capacity
        new_cap = self.round_capacity(cap)
        if new_cap != cap:
            field = grow_capacity(field, new_cap)
            opt_state = tr.pad_opt_state(opt_state, cap, new_cap)
            stats = dn.DensifyStats.zeros(new_cap, field.device)
        if self.zero2:
            opt_state = dp.shard_opt_state(opt_state, new_cap, self.group)
        elif self.kind == "gauss":
            field, opt_state, stats = gs.shard_rows(
                gs.spread_rows((field, opt_state, stats), new_cap, self.world),
                new_cap, self.rank, self.world)
        return field, opt_state, stats

    def capacity(self, field) -> int:
        """The run's (global) capacity."""
        return field.capacity * (self.world if self.kind == "gauss" else 1)

    def local_mask(self, mask: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a [capacity] mask over the optimizer state's rows."""
        if not self.zero2:
            return mask
        rows = mask.shape[0] // self.world
        return mask[self.rank * rows:(self.rank + 1) * rows]

    def full(self, field, opt_state, stats):
        """The full-capacity state, gathered (a collective: every rank calls it)."""
        if self.zero2:
            opt_state = dp.gather_opt_state(opt_state, field.capacity // self.world,
                                            self.group)
        elif self.kind == "gauss":
            field, opt_state, stats = gs.gather_rows((field, opt_state, stats),
                                                     field.capacity, self.group)
        return field, opt_state, stats

    def step(self, field, opt_state, stats, views, targets, bg, *, settings, optimizer,
             include_feature: bool, lambda_dssim: float) -> tr.StepOutput:
        """One training step over this rank's `views` (lists of view, projection and
        centre matrices) and `targets` (lists of images or feature maps, and of masks);
        multi-device steps report the group's summed drops, so every rank re-runs alike."""
        kw = dict(settings=settings, optimizer=optimizer)
        view, gt, mask = [m[0] for m in views], targets[0][0], targets[1][0]
        if self.kind is None:
            if include_feature:
                return tr.train_step_feature(field, opt_state, stats, *view, gt, mask, bg,
                                             **kw)
            return tr.train_step_rgb(field, opt_state, stats, *view, gt, bg,
                                     lambda_dssim=lambda_dssim, **kw)
        if self.kind == "depth":
            field, opt_state, loss, dropped, rect = depth_feature_step(
                field, opt_state, *view, gt, mask, bg, group=self.group, **kw)
        else:
            kw.update(include_feature=include_feature, lambda_dssim=lambda_dssim)
            o = (dp.dp_train_step(field, opt_state, stats, *views, *targets, bg,
                                  group=self.group, zero2=self.zero2, **kw)
                 if self.kind == "data" else
                 gs.gauss_train_step(field, opt_state, stats, *views, *targets, bg,
                                     capacity=self.capacity(field),
                                     gauss_group=self.group, **kw))
            field, opt_state, stats, loss = o.field, o.opt_state, o.stats, o.loss
            dropped, rect = o.dropped, o.rect_dropped
        return tr.StepOutput(field, opt_state, stats, loss, loss, torch.zeros(()),
                             dropped, rect)

    def cameras(self, iteration: int, schedule) -> tuple[list, object, list]:
        """(this rank's cameras of `iteration`, the camera whose size sets the settings,
        the cameras to prefetch) from `schedule` (`train/loop.py Schedule`). Data-parallel
        iteration i takes positions [(i-1) B, i B), B = world * views a rank, rank r the
        r-th slice, all of one size; other layouts take position i - 1, prefetching the
        next in its epoch."""
        if self.kind != "data":
            cam = schedule(iteration - 1)
            return [cam], cam, [schedule(iteration)] if iteration % len(schedule) else []
        v, size = self.views_per_rank, self.world * self.views_per_rank
        cams = [schedule((iteration - 1) * size + j) for j in range(size)]
        cam = cams[0]
        for c in cams[1:]:
            if (c.height, c.width) != (cam.height, cam.width):
                raise ValueError("data-parallel training requires uniform image sizes "
                                 f"across the view batch, got {c.height}x{c.width} vs "
                                 f"{cam.height}x{cam.width}")
        mine = cams[self.rank * v:(self.rank + 1) * v]
        return mine, cam, mine + [schedule(iteration * size + self.rank * v + j)
                                  for j in range(v)]

    def densify(self, field, stats, gen: torch.Generator, **rule) -> dn.DensifyResult:
        """Densify and prune with split noise from `gen`; Gaussian-sharded, the whole
        capacity's noise as one process draws it, then shard-local slots."""
        if self.kind != "gauss":
            return dn.densify_and_prune(field, stats, gen, **rule)
        noise = torch.randn((self.capacity(field), 2, 3), generator=gen,
                            dtype=field.xyz.dtype, device=field.xyz.device)
        return sharded_densify(field, stats, noise, group=self.group, **rule)

    def viewer_field(self, field, gui):
        """The field the viewer renders (`gui`: rank 0's viewer, else None). Gaussian-
        sharded, a collective: every rank learns whether a viewer is connected and, while
        one is, joins the gather of the whole field (None while none is)."""
        if self.kind != "gauss":
            return field
        if gui is not None and gui.conn is None:
            gui.try_connect()
        connected = col.max_(torch.tensor([int(gui is not None and gui.conn is not None)],
                                          device=field.xyz.device))
        return gs.gather_rows(field, field.capacity, self.group) if int(connected[0]) \
            else None

    def grow(self, field, opt_state, new_cap: int):
        """Grow to `new_cap` (rounded up to the layout's multiple) and lay the state out
        again; the statistics restart at zero. Returns (field, opt_state, stats)."""
        new_cap = self.round_capacity(new_cap)
        field, opt_state, _ = self.full(field, opt_state, None)
        old_cap = field.capacity
        field = grow_capacity(field, new_cap)
        opt_state = tr.pad_opt_state(opt_state, old_cap, new_cap)
        return self.setup(field, opt_state, dn.DensifyStats.zeros(new_cap, field.device))

    def replicated_hash(self, field, opt_state, stats) -> str:
        """A hash of every tensor this layout replicates over the ranks: all of the
        state, but for the split moments (ZeRO-2) or split rows (gauss)."""
        leaves = [s[k] for label in sorted(opt_state) for s in [opt_state[label]]
                  for k in sorted(s) if s[k].dim() == 0 or not self.split_rows]
        if self.kind != "gauss":
            leaves += [t for t in vars(field).values() if t is not None]
            leaves += [getattr(stats, n) for n in dn.STAT_NAMES]
        return _hash(leaves)
