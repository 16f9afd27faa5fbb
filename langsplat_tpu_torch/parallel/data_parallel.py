"""Data-parallel training step: views split across ranks, parameters replicated,
gradients all-reduced; optionally ZeRO-2 (the optimizer state split by rows).

Counterpart of `langsplat_tpu/parallel/data_parallel.py:39 make_dp_train_step` and
`:164 shard_opt_state`. Each rank renders its local views, each with its own means2D
tap, and differentiates the mean of its local losses (view by view, which JAX vmaps);
then, over the group:
  - the loss is averaged; `dropped` and `rect_dropped` are summed;
  - the densification statistics: each view's tap gradient norm, in the half-image units
    the threshold is calibrated to and times `v_local` (undoing the local mean), summed
    over views and ranks with the visibility counts; the screen radii maxed;
  - the gradients are averaged (sum over ranks / world), and Adam runs on the replicated
    parameters; with ZeRO-2 they are reduce-scattered along rows and divided by the
    world size instead, each rank runs Adam on its capacity // world rows with its shard
    of the moments, and the new rows are all-gathered. The elementwise Adam on the same
    summed gradients gives the replicated step's values.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from langsplat_tpu_torch.core import losses
from langsplat_tpu_torch.models.gaussian_field import GaussianField
from langsplat_tpu_torch.ops.render import RenderSettings, render
from langsplat_tpu_torch.parallel import collectives as col
from langsplat_tpu_torch.train.densify import DensifyStats
from langsplat_tpu_torch.train.trainer import extract_params, merge_params


class DpStepOutput(NamedTuple):
    field: GaussianField
    opt_state: dict
    stats: DensifyStats
    loss: torch.Tensor
    dropped: torch.Tensor        # [] int64, summed over views and ranks
    rect_dropped: torch.Tensor   # [] int64
    grads: dict | None           # the averaged gradients, when asked for


def flat_rows(tensors: dict) -> torch.Tensor:
    """[cap, ...] tensors -> one [cap, D] tensor (keys in sorted order)."""
    return torch.cat([tensors[k].reshape(tensors[k].shape[0], -1)
                      for k in sorted(tensors)], dim=1)


def unflat_rows(flat: torch.Tensor, like: dict) -> dict:
    """Inverse of `flat_rows`, shaped like `like` along everything but the rows."""
    out, col0 = {}, 0
    for k in sorted(like):
        shape = tuple(like[k].shape[1:])
        width = math.prod(shape)
        out[k] = flat[:, col0:col0 + width].reshape((flat.shape[0],) + shape)
        col0 += width
    return out


def stat_scale(settings: RenderSettings, device) -> torch.Tensor:
    return torch.tensor([0.5 * settings.image_width, 0.5 * settings.image_height],
                        dtype=torch.float32, device=device)


def view_loss(out: dict, gt, mask, include_feature: bool, lambda_dssim: float):
    if include_feature:
        return losses.masked_l1_loss(out["language_feature_image"], gt, mask)
    return losses.rgb_loss(out["render"], gt, lambda_dssim)


def local_views_grads(field: GaussianField, include_feature: bool, n_views: int,
                      render_view, loss_of_view):
    """Differentiate the mean of `n_views` local view losses, one view at a time:
    `render_view(f, v, tap)` renders view v of field f with the means2D tap, and
    `loss_of_view(out, v)` is its loss. Returns (mean loss, summed parameter grads,
    per-view [(tap grad * n_views, visibility, radii)], dropped, rect_dropped)."""
    params = extract_params(field, include_feature)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    keys = sorted(leaves)
    f = merge_params(field, leaves)
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss = torch.zeros((), dtype=torch.float32, device=field.device)
    dropped = torch.zeros((), dtype=torch.int64, device=field.device)
    rect = torch.zeros((), dtype=torch.int64, device=field.device)
    taps = []
    for v in range(n_views):
        tap = torch.zeros((field.capacity, 2), dtype=torch.float32, device=field.device,
                          requires_grad=True)
        out = render_view(f, v, tap)
        loss_v = loss_of_view(out, v)
        g = torch.autograd.grad(loss_v / n_views, [leaves[k] for k in keys] + [tap],
                                allow_unused=True)
        for k, gk in zip(keys, g[:-1]):
            if gk is not None:
                grads[k] = grads[k] + gk
        ss = g[-1] if g[-1] is not None else torch.zeros_like(tap)
        taps.append((ss * n_views, out["visibility_filter"], out["radii"]))
        loss = loss + loss_v.detach()
        dropped = dropped + out["instances_dropped"].to(torch.int64)
        rect = rect + out["rect_dropped"].to(torch.int64)
    return loss / n_views, grads, taps, dropped, rect


def tap_stats(taps, settings: RenderSettings, capacity: int, device):
    """Per-view gradient norms in half-image units (visible views only), visibility
    counts and the largest radius, summed / maxed over the local views."""
    scale = stat_scale(settings, device)
    gnorm = torch.zeros(capacity, dtype=torch.float32, device=device)
    denom = torch.zeros(capacity, dtype=torch.float32, device=device)
    radii = torch.zeros(capacity, dtype=torch.float32, device=device)
    for ss, vis, rad in taps:
        visf = vis.to(torch.float32)
        gnorm = gnorm + torch.linalg.vector_norm(ss[:, :2] * scale, dim=-1) * visf
        denom = denom + visf
        radii = torch.maximum(radii, torch.where(vis, rad.to(torch.float32), 0.0))
    return gnorm, denom, radii


def shard_opt_state(opt_state: dict, capacity: int, group=None) -> dict:
    """This rank's rows [r cap/n, (r+1) cap/n) of every [capacity, ...] optimizer leaf
    (ZeRO-2 layout); the scalar counts stay replicated."""
    n, r = col.size(group), col.rank(group)
    if capacity % n:
        raise ValueError(f"capacity {capacity} must divide by the group size {n}")
    rows = capacity // n

    def cut(x):
        return x[r * rows:(r + 1) * rows].clone() if x.dim() >= 1 and \
            x.shape[0] == capacity else x
    return {label: {k: cut(v) for k, v in s.items()} for label, s in opt_state.items()}


def gather_opt_state(opt_state: dict, shard_rows: int, group=None) -> dict:
    """The full optimizer state from every rank's ZeRO-2 rows."""
    def full(x):
        return col.all_gather_rows(x, group) if x.dim() >= 1 and \
            x.shape[0] == shard_rows else x
    return {label: {k: full(v) for k, v in s.items()} for label, s in opt_state.items()}


def dp_train_step(field: GaussianField, opt_state: dict, stats: DensifyStats,
                  viewmats, projmats, campos, gts, masks, bg, *,
                  settings: RenderSettings, optimizer, include_feature: bool,
                  lambda_dssim: float = 0.2, group=None, zero2: bool = False,
                  return_grads: bool = False) -> DpStepOutput:
    """One data-parallel step over this rank's local views (sequences of v_local
    [4,4], [4,4], [3] matrices and [C,H,W] / [1,H,W] targets). With `zero2`, `opt_state`
    holds this rank's rows (`shard_opt_state`)."""
    cap = field.capacity
    device = field.device
    n = col.size(group)
    if zero2 and cap % n:
        raise ValueError(f"capacity {cap} must divide by the group size {n}")

    def render_view(f, v, tap):
        return render(f, settings, viewmats[v], projmats[v], campos[v], bg,
                      screenspace_offset=tap)

    def loss_of_view(out, v):
        return view_loss(out, gts[v], masks[v], include_feature, lambda_dssim)

    local_loss, grads, taps, drop, rect = local_views_grads(
        field, include_feature, len(viewmats), render_view, loss_of_view)
    gnorm, denom, radii = tap_stats(taps, settings, cap, device)

    loss = col.mean(local_loss, group)
    counts = col.sum_(torch.stack([drop, rect]), group)
    sums = col.sum_(torch.stack([gnorm, denom]), group)
    max_radii = col.max_(radii, group)

    params = extract_params(field, include_feature)
    flat = flat_rows(grads)
    if zero2:
        rows = cap // n
        r = col.rank(group)
        g_shard = unflat_rows(col.reduce_scatter_rows(flat, group) / n, grads)
        p_shard = {k: v[r * rows:(r + 1) * rows] for k, v in params.items()}
        new_shard, opt_state = optimizer.update(g_shard, opt_state, p_shard)
        new_params = unflat_rows(col.all_gather_rows(flat_rows(new_shard), group),
                                 new_shard)
        grads = None if not return_grads else unflat_rows(
            col.all_gather_rows(flat_rows(g_shard), group), grads)
    else:
        grads = unflat_rows(col.mean(flat, group), grads)
        new_params, opt_state = optimizer.update(grads, opt_state, params)
    new_stats = DensifyStats(grad_accum=stats.grad_accum + sums[0],
                             denom=stats.denom + sums[1],
                             max_radii2d=torch.maximum(stats.max_radii2d, max_radii))
    return DpStepOutput(merge_params(field, new_params), opt_state, new_stats, loss,
                        counts[0], counts[1], grads if return_grads else None)
