"""Depth-sharded blending: each rank blends one contiguous interval of the global depth
order, and the partial blend states are composed in depth order.

Counterpart of `langsplat_tpu/parallel/depth_sharded.py`: `_make_mapped_render` (:41),
`make_depth_sharded_render` (:156), `depth_sharded_render_full` (:183) and
`make_depth_sharded_feature_step` (:225). Rank d keeps the Gaussians whose depth rank
(visible ones by depth, ties by index, as `ops/tiles.bin_gaussians` orders them) falls in
[d s, (d+1) s), s = ceil(capacity / D), bins them against budget // D and blends them
with a zero background (K1), giving the partial state (C_d, F_d, T_d). The states are
all-gathered and composed front to back, (C_a + T_a C_b, T_a T_b), and T_total * bg is
added to RGB. Every rank then holds the whole image and takes the same loss; the
gather's backward (a reduce-scatter) hands each rank the gradient of its own state
times D, so the group mean of the ranks' parameter gradients is the single-device
gradient. That backward sends a non-zero dL/dT_final into K2 on every shard but the
last.
"""

from __future__ import annotations

import dataclasses

import torch

from langsplat_tpu_torch.core import losses
from langsplat_tpu_torch.ops.projection import PreprocessOut
from langsplat_tpu_torch.ops.render import RenderSettings, blend, unit_features
from langsplat_tpu_torch.ops.tiles import bin_gaussians
from langsplat_tpu_torch.parallel import collectives as col
from langsplat_tpu_torch.parallel.spatial import preprocess_view
from langsplat_tpu_torch.train.trainer import extract_params, merge_params


def depth_interval_mask(prep: PreprocessOut, shard: int, n_shards: int) -> torch.Tensor:
    """[N] bool: the Gaussians whose global depth rank lies in interval `shard`."""
    n = prep.depths.shape[0]
    size = -(-n // n_shards)
    keys = torch.where(prep.visible, prep.depths.detach(), torch.inf)
    by_depth = torch.sort(keys, stable=True).indices
    rank = torch.empty(n, dtype=torch.int64, device=keys.device)
    rank[by_depth] = torch.arange(n, device=keys.device)
    return (rank >= shard * size) & (rank < (shard + 1) * size)


def depth_render(field, settings: RenderSettings, viewmatrix, projmatrix, campos, bg,
                 group=None) -> dict:
    """One view with the depth order split over the ranks of `group`: `render`,
    `final_transmittance`, `radii`, `visibility_filter`, the drop counters summed over
    the shards, and `language_feature_image` with features; the same on every rank."""
    n, d = col.size(group), col.rank(group)
    cap = field.capacity
    budget = (settings.budget or 6 * cap) // n
    prep = preprocess_view(field, settings, viewmatrix, projmatrix, campos)
    prep_d = prep._replace(visible=prep.visible & depth_interval_mask(prep, d, n))
    opac = field.get_opacity[:, 0]
    feats = unit_features(field) if settings.include_feature else None
    inst = bin_gaussians(PreprocessOut(*(t.detach() for t in prep_d)),
                         grid_x=settings.grid_x, grid_y=settings.grid_y, budget=budget,
                         max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
                         tile_size=settings.tile_size, opacities=opac.detach())
    out = blend(prep_d, inst, opac, feats, torch.zeros_like(bg), settings)

    parts = [out["render"], out["final_transmittance"][None]]
    if feats is not None:
        parts.insert(1, out["language_feature_image"])
    state = torch.cat(parts, dim=0)                                 # [3 (+F) + 1, H, W]
    states = col.all_gather_rows(state[None], group)                # [D, ...]
    c_acc = torch.zeros_like(state[:3])
    f_acc = torch.zeros_like(state[3:-1])
    t_acc = torch.ones_like(state[-1])
    for s in states:
        c_acc = c_acc + t_acc[None] * s[:3]
        f_acc = f_acc + t_acc[None] * s[3:-1]
        t_acc = t_acc * s[-1]
    counts = col.sum_(torch.stack([inst.dropped.to(torch.int64),
                                   inst.rect_dropped.to(torch.int64)]), group)
    result = {"render": c_acc + t_acc[None] * bg[:, None, None],
              "final_transmittance": t_acc, "radii": prep.radii,
              "visibility_filter": prep.radii > 0,
              "instances_dropped": counts[0], "rect_dropped": counts[1]}
    if feats is not None:
        result["language_feature_image"] = f_acc
    return result


@torch.no_grad()
def depth_render_full(field, settings: RenderSettings, viewmatrix, projmatrix, campos,
                      bg, group=None, budget_cap_factor: int = 10) -> dict:
    """`depth_render`, retried with a grown budget (by 1.5x, at least one shard quantum,
    up to budget_cap_factor * capacity) while instances drop, and a doubled
    max_tiles_per_gaussian (up to the tile grid) while rect positions drop. Every rank
    reads the same summed counters, so all retry together."""
    cap = field.capacity
    budget = settings.budget or 6 * cap
    budget_cap = budget_cap_factor * cap
    n = col.size(group)
    tmax = settings.max_tiles_per_gaussian
    grid_cap = settings.grid_x * settings.grid_y
    while True:
        s = dataclasses.replace(settings, budget=budget, max_tiles_per_gaussian=tmax)
        out = depth_render(field, s, viewmatrix, projmatrix, campos, bg, group)
        dropped, rect = int(out["instances_dropped"]), int(out["rect_dropped"])
        if dropped == 0 and rect == 0:
            out["settings"] = s
            return out
        grew = False
        if rect > 0 and tmax < grid_cap:
            tmax = min(tmax * 2, grid_cap)
            grew = True
        if dropped > 0 and budget < budget_cap:
            budget = min(max(int(budget * 1.5), budget + n), budget_cap)
            grew = True
        if not grew:
            raise RuntimeError(
                f"depth-sharded render dropped {dropped} instances at budget cap "
                f"{budget_cap} + {rect} rect positions at max_tiles={tmax}; raise "
                f"budget_cap_factor")


def depth_feature_step(field, opt_state: dict, viewmatrix, projmatrix, campos,
                       gt_feature, feature_mask, bg, *, settings: RenderSettings,
                       optimizer, group=None):
    """Phase-B step over the depth-sharded render: masked feature L1, geometry frozen,
    the language-feature gradient averaged over the group, then Adam (replicated).
    Returns (field, opt_state, loss, dropped, rect_dropped)."""
    params = extract_params(field, include_feature=True)
    leaf = params["language_feature"].detach().requires_grad_(True)
    out = depth_render(merge_params(field, {"language_feature": leaf}), settings,
                       viewmatrix, projmatrix, campos, bg, group)
    loss = losses.masked_l1_loss(out["language_feature_image"], gt_feature,
                                 feature_mask)
    (grad,) = torch.autograd.grad(loss, [leaf])
    with torch.no_grad():
        grads = {"language_feature": col.mean(grad, group)}
        new_params, opt_state = optimizer.update(grads, opt_state, params)
    return (merge_params(field, new_params), opt_state, loss.detach(),
            out["instances_dropped"], out["rect_dropped"])
