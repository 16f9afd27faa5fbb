"""One multi-device step or render on freshly spawned ranks, from plain inputs: how a
layout is held against its single-process counterpart.

`run(tasks)` is the function `launch.spawn` starts on every rank: it runs each
(name, spec) of `tasks` in turn and returns the list of their outputs (numpy arrays and
numbers, gathered to full capacity). A spec holds picklable values only: numpy arrays,
`RenderSettings`, `OptimizationConfig`; a field comes as its numpy leaves ("params") or a
checkpoint path ("checkpoint"), views as lists of numpy matrices. The same functions run
in one process without a process group (every collective is then the identity), which is
the serial step they are held against.

    outs = launch.spawn(runner.run, ([("dp_step", spec)],), 4, device_type="cpu")
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import sys
import types

import numpy as np
import torch

from langsplat_tpu_torch.config import PipelineConfig
from langsplat_tpu_torch.models import field_io
from langsplat_tpu_torch.models.gaussian_field import FIELD_NAMES, from_numpy
from langsplat_tpu_torch.ops.render import render
from langsplat_tpu_torch.parallel import collectives as col
from langsplat_tpu_torch.parallel import data_parallel as dp
from langsplat_tpu_torch.parallel import launch
from langsplat_tpu_torch.parallel import mesh as mesh_lib
from langsplat_tpu_torch.parallel.depth_sharded import (depth_feature_step, depth_render,
                                                        depth_render_full)
from langsplat_tpu_torch.parallel.dp_spatial import dp_spatial_train_step
from langsplat_tpu_torch.parallel.gauss_densify import sharded_densify
from langsplat_tpu_torch.parallel.gauss_sharded import (gather_rows, gauss_train_step,
                                                        shard_rows)
from langsplat_tpu_torch.parallel.layout import Layout
from langsplat_tpu_torch.parallel.spatial import spatial_render
from langsplat_tpu_torch.train import densify as dn
from langsplat_tpu_torch.train import trainer as tr


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


@functools.lru_cache(maxsize=1)
def _checkpoint(path: str, device: torch.device):
    """A checkpoint's whole training state (`field_io.load_checkpoint`), read once for
    the tasks of a `run` that share it."""
    return field_io.load_checkpoint(path, device=device)


def _field(spec, device):
    if "checkpoint" in spec:
        field = _checkpoint(spec["checkpoint"], device)[0]
        if spec.get("include_feature") and field.language_feature is None:
            field = field.with_language_feature(
                3, generator=torch.Generator().manual_seed(spec.get("seed", 0)))
        return field
    return from_numpy(spec["params"], device)


def _field_np(field) -> dict:
    return {n: _np(getattr(field, n)) for n in FIELD_NAMES
            if getattr(field, n) is not None}


def _bg(spec, device):
    return torch.as_tensor(np.asarray(spec["bg"]), dtype=torch.float32, device=device)


def _tensors(xs, device):
    return [torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
            for x in xs]


def _views(spec, device, lo: int, hi: int):
    return tuple(_tensors(spec[k][lo:hi], device) for k in
                 ("viewmats", "projmats", "campos", "gts", "masks"))


def _optimizer(spec, field, include_feature: bool):
    """The optimizer and its state: from "opt_leaves", from the checkpoint with
    "resume" (with the checkpoint's spatial learning-rate scale), or fresh."""
    scale = spec.get("spatial_lr_scale", 1.0)
    state = None
    if spec.get("resume"):
        _, state, _, _, scale, _ = _checkpoint(spec["checkpoint"], field.device)
    opt = tr.make_optimizer(spec["opt_config"], scale, include_feature)
    if "opt_leaves" in spec:
        state = tr.opt_state_from_numpy(spec["opt_leaves"], include_feature,
                                        field.device)
    return opt, state if state is not None else \
        opt.init(tr.extract_params(field, include_feature))


def _stats(spec, capacity, device):
    if "stats" in spec:
        return dn.DensifyStats(*_tensors(spec["stats"], device))
    if spec.get("resume"):
        return _checkpoint(spec["checkpoint"], device)[2]
    return dn.DensifyStats.zeros(capacity, device)


def _step_out(field, opt_state, stats, loss, dropped, rect, extra=None) -> dict:
    out = dict(field=_field_np(field), opt_leaves=tr.opt_state_leaves(opt_state),
               stats=[_np(getattr(stats, n)) for n in dn.STAT_NAMES],
               loss=float(loss), dropped=int(dropped), rect_dropped=int(rect))
    return out | (extra or {})


def _until_nothing_drops(step, settings, capacity: int):
    """Run step(settings) until nothing drops; (output, settings). Not the training
    loop's rule: max_tiles doubles up to the tile grid while rect positions drop, the
    budget grows 1.5x, in no granule, up to 64 x capacity while instances drop. The
    counts are the group's sums, so every rank grows alike."""
    grid_cap = settings.grid_x * settings.grid_y
    while True:
        out = step(settings)
        dropped, rect = int(out.dropped), int(out.rect_dropped)
        if dropped == 0 and rect == 0:
            return out, settings
        tmax, budget = settings.max_tiles_per_gaussian, settings.budget
        if rect:
            tmax = min(tmax * 2, grid_cap)
        if dropped:
            budget = min(int(budget * 1.5), 64 * capacity)
        if (tmax, budget) == (settings.max_tiles_per_gaussian, settings.budget):
            raise RuntimeError(f"{dropped} instances / {rect} rect positions dropped at "
                               f"budget {budget}, max_tiles {tmax}")
        settings = dataclasses.replace(settings, max_tiles_per_gaussian=tmax,
                                       budget=budget)


def dp_step(spec, device):
    """`data_parallel.dp_train_step`: the V views split over the world in order, each
    rank its V / world (spec: params or checkpoint [+ resume], settings, opt_config,
    viewmats, projmats, campos, gts, masks, bg, include_feature, lambda_dssim, zero2,
    return_grads, grow: re-run at grown caps until nothing drops)."""
    feat = spec["include_feature"]
    field = _field(spec, device)
    opt, state = _optimizer(spec, field, feat)
    stats = _stats(spec, field.capacity, device)
    n, r = col.size(), col.rank()
    v = len(spec["viewmats"]) // n
    zero2 = spec.get("zero2", False)
    if zero2:
        state = dp.shard_opt_state(state, field.capacity)
    views = _views(spec, device, r * v, (r + 1) * v)
    bg = _bg(spec, device)

    def step(settings):
        return dp.dp_train_step(field, state, stats, *views, bg, settings=settings,
                                optimizer=opt, include_feature=feat,
                                lambda_dssim=spec.get("lambda_dssim", 0.2), zero2=zero2,
                                return_grads=spec.get("return_grads", False))
    if spec.get("grow"):
        o, settings = _until_nothing_drops(step, spec["settings"], field.capacity)
    else:
        o, settings = step(spec["settings"]), spec["settings"]
    state = dp.gather_opt_state(o.opt_state, field.capacity // n) if zero2 \
        else o.opt_state
    extra = dict(budget=settings.budget, max_tiles=settings.max_tiles_per_gaussian)
    if o.grads is not None:
        extra["grads"] = _np(o.grads)
    return _step_out(o.field, state, o.stats, o.loss, o.dropped, o.rect_dropped, extra)


def dp_spatial_step(spec, device):
    """`dp_spatial.dp_spatial_train_step` on the 2-D ('data', 'tiles') mesh."""
    feat = spec["include_feature"]
    mesh = mesh_lib.make_mesh(col.size(), ("data", "tiles"), device.type) \
        if col.size() > 1 else None
    field = _field(spec, device)
    opt, state = _optimizer(spec, field, feat)
    stats = _stats(spec, field.capacity, device)
    nd, d = mesh_lib.axis_size(mesh, "data"), mesh_lib.axis_index(mesh, "data")
    v = len(spec["viewmats"]) // nd
    o = dp_spatial_train_step(field, state, stats, *_views(spec, device, d * v,
                                                           (d + 1) * v),
                              _bg(spec, device),
                              settings=spec["settings"], optimizer=opt,
                              include_feature=feat,
                              lambda_dssim=spec.get("lambda_dssim", 0.2), mesh=mesh)
    return _step_out(o.field, o.opt_state, o.stats, o.loss, o.dropped, o.rect_dropped)


def gauss_step(spec, device):
    """`gauss_sharded.gauss_train_step` on a ('gauss',) mesh, or ('data', 'gauss') with
    spec["data_axis"]; rows split as given (no spread), outputs gathered."""
    feat = spec["include_feature"]
    axes = ("data", "gauss") if spec.get("data_axis") else ("gauss",)
    mesh = mesh_lib.make_mesh(col.size(), axes, device.type) if col.size() > 1 else None
    ng, g = mesh_lib.axis_size(mesh, "gauss"), mesh_lib.axis_index(mesh, "gauss")
    gauss_group = mesh_lib.axis_group(mesh, "gauss")
    data_group = mesh_lib.axis_group(mesh, "data") if spec.get("data_axis") else None
    field = _field(spec, device)
    cap = field.capacity
    opt, state = _optimizer(spec, field, feat)
    stats = _stats(spec, cap, device)
    field, state, stats = shard_rows((field, state, stats), cap, g, ng)
    nd = mesh_lib.axis_size(mesh, "data") if data_group is not None else 1
    d = mesh_lib.axis_index(mesh, "data") if data_group is not None else 0
    v = len(spec["viewmats"]) // nd
    o = gauss_train_step(field, state, stats, *_views(spec, device, d * v, (d + 1) * v),
                         _bg(spec, device),
                         settings=spec["settings"], optimizer=opt, include_feature=feat,
                         capacity=cap, lambda_dssim=spec.get("lambda_dssim", 0.2),
                         gauss_group=gauss_group, data_group=data_group)
    field, state, stats = gather_rows((o.field, o.opt_state, o.stats), cap // ng,
                                      gauss_group)
    return _step_out(field, state, stats, o.loss, o.dropped, o.rect_dropped)


def _render_and_grads(render_fn, spec, device):
    """Images of one view and the gradients of sum(image * weight) over every channel
    with respect to the field's float leaves, averaged over the group (each rank
    computes the same loss from the gathered image)."""
    field = _field(spec, device)
    names = spec.get("grad_of", ())
    leaves = {n: getattr(field, n).detach().requires_grad_(True) for n in names}
    f = dataclasses.replace(field, **leaves)
    view, proj, campos = _tensors((spec["viewmats"][0], spec["projmats"][0],
                                   spec["campos"][0]), device)
    out = render_fn(f, spec["settings"], view, proj, campos,
                    _bg(spec, device))
    images = {k: out[k] for k in ("render", "language_feature_image",
                                  "final_transmittance") if k in out}
    result = {k: _np(v) for k, v in images.items()}
    result["instances_dropped"] = int(out["instances_dropped"])
    result["rect_dropped"] = int(out["rect_dropped"])
    if names:
        loss = sum((images[k] * torch.as_tensor(spec["weights"][k], device=device)).sum()
                   for k in spec["weights"])
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        result["grads"] = {n: _np(col.mean(g)) for n, g in zip(names, grads)}
    return result


def spatial_step(spec, device):
    """`spatial.spatial_render` of view 0, bands over the world (spec as for the steps,
    plus grad_of and weights)."""
    return _render_and_grads(spatial_render, spec, device)


def render_step(spec, device):
    """`ops.render.render` of view 0 in one process: the single-device reference."""
    return _render_and_grads(render, spec, device)


def depth_step(spec, device):
    """`depth_sharded.depth_render` of view 0, depth intervals over the world."""
    return _render_and_grads(depth_render, spec, device)


def depth_full(spec, device):
    """`depth_sharded.depth_render_full` of view 0: the image and the caps it grew to."""
    field = _field(spec, device)
    view, proj, campos = _tensors((spec["viewmats"][0], spec["projmats"][0],
                                   spec["campos"][0]), device)
    out = depth_render_full(field, spec["settings"], view, proj, campos,
                            _bg(spec, device))
    return dict(render=_np(out["render"]), budget=out["settings"].budget,
                max_tiles=out["settings"].max_tiles_per_gaussian)


def depth_feature(spec, device):
    """`depth_sharded.depth_feature_step` on view 0."""
    field = _field(spec, device)
    opt, state = _optimizer(spec, field, True)
    view, proj, campos, gt, mask = _views(spec, device, 0, 1)
    f, state, loss, dropped, rect = depth_feature_step(
        field, state, view[0], proj[0], campos[0], gt[0], mask[0],
        _bg(spec, device), settings=spec["settings"],
        optimizer=opt)
    return _step_out(f, state, dn.DensifyStats.zeros(f.capacity, device), loss,
                     dropped, rect)


def densify(spec, device):
    """`gauss_densify.sharded_densify` with rows split as given over the world (spec:
    params, stats, noise, rule = the densify keywords)."""
    field = _field(spec, device)
    cap = field.capacity
    stats = _stats(spec, cap, device)
    n, r = col.size(), col.rank()
    field, stats = shard_rows((field, stats), cap, r, n)
    res = sharded_densify(field, stats, torch.as_tensor(spec["noise"], device=device),
                          **spec["rule"])
    field, mask = gather_rows((res.field, res.reset_mask), cap // n)
    return dict(field=_field_np(field), reset_mask=_np(mask),
                overflow=int(res.overflow), num_alive=int(res.num_alive))


def viewer_field(spec, device):
    """`Layout.viewer_field`, Gaussian-sharded over the world, rank 0's viewer connected
    or not (spec: params, connected): the field this rank got back, the collectives it
    joined and the viewer's connection attempts."""
    layout = Layout.from_config(PipelineConfig(gauss_shards=col.size()), False, device)
    field, _, _ = layout.setup(_field(spec, device), {}, None)
    attempts = []
    gui = None if col.rank() else types.SimpleNamespace(
        conn=object() if spec["connected"] else None,
        try_connect=lambda: attempts.append(1))
    col.reset()
    got = layout.viewer_field(field, gui)
    calls = {name: rec["calls"] for name, rec in col.timings().items()}
    return dict(gathered=got is not None, field={} if got is None else _field_np(got),
                calls=calls, connect_attempts=len(attempts))


def collectives_check(spec, device):
    """Every collective of `collectives.py` on this rank's device against the values
    computed here on the CPU (spec: rows, cols): the largest absolute difference each."""
    n, r = col.size(), col.rank()
    rows, cols = spec.get("rows", 8 * n), spec.get("cols", 5)
    gen = torch.Generator().manual_seed(1234)
    every = torch.randn((n, rows, cols), generator=gen)      # every rank's values
    mine = every[r].to(device)
    err = {}

    def diff(name, got, want):
        err[name] = float((got.detach().cpu().to(torch.float64)
                           - want.to(torch.float64)).abs().max())

    diff("sum", col.sum_(mine), every.sum(0))
    diff("mean", col.mean(mine), every.sum(0) / n)
    diff("max", col.max_(mine), every.amax(0))
    ints = torch.arange(rows, dtype=torch.int64)[:, None] * (r + 1)
    diff("sum_int64", col.sum_(ints.to(device)),
         torch.arange(rows, dtype=torch.int64)[:, None] * (n * (n + 1) // 2))
    c = rows // n
    diff("reduce_scatter_rows", col.reduce_scatter_rows(mine), every.sum(0)[r * c:(r + 1) * c])
    leaf = mine.clone().requires_grad_(True)
    gathered = col.all_gather_rows(leaf)
    diff("all_gather_rows", gathered, every.reshape(n * rows, cols))
    weight = torch.linspace(-1.0, 1.0, n * rows * cols).reshape(n * rows, cols)
    (g,) = torch.autograd.grad((gathered * weight.to(device)).sum(), [leaf])
    # the backward: each rank's rows of the summed (over ranks) gradient, n * weight
    diff("all_gather_rows_backward", g, n * weight[r * rows:(r + 1) * rows])
    objs = col.gather_object({"rank": r})
    err["gather_object"] = 0.0 if objs == [{"rank": i} for i in range(n)] else 1.0
    col.barrier()
    # a rank imports the port and nothing of JAX, the JAX package or the tests
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "langsplat_tpu", "tests"))
    return dict(errors=err, backend=col.backend(), device=str(device), world=n,
                foreign_modules=foreign)


TASKS = {f.__name__: f for f in (dp_step, dp_spatial_step, gauss_step, spatial_step,
                                 render_step,
                                 depth_step, depth_full, depth_feature, densify,
                                 viewer_field, collectives_check)}


def digest(out) -> str:
    """A hash of every array and number of a task's output."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        else:
            h.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    walk(out)
    return h.hexdigest()


def run(tasks: list, device: str | torch.device | None = None) -> list:
    """Run each (name, spec) of `tasks` on this rank's device (a spawned rank's, else
    `device`, else the CPU); the list of their outputs, each with its `digest`. With
    spec["rank0_only"], the other ranks return the digest alone (full-width outputs)."""
    device = torch.device(launch.current_device() or device or "cpu")
    outs = []
    try:
        for name, spec in tasks:
            out = TASKS[name](spec, device)
            out["digest"] = digest(out)
            if spec.get("rank0_only") and col.rank() != 0:
                out = {"digest": out["digest"]}
            outs.append(out)
    finally:
        _checkpoint.cache_clear()
    return outs
