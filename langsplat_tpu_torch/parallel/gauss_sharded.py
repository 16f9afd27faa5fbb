"""Gaussian-axis sharded training: parameters, Adam moments and densification statistics
split by rows over the ranks; blending split by tile bands over the same ranks.

Counterpart of `langsplat_tpu/parallel/gauss_sharded.py`: `capacity_specs` (:58) and
`shard_state` (:68) are `shard_rows` here (every [capacity, ...] leaf cut by rows,
everything else replicated; `gather_rows` undoes it), `spread_rows` (:76), and
`make_gauss_sharded_train_step` (:101) is `gauss_train_step`, with its 2-D ('data',
'gauss') form. Rank g of the 'gauss' axis holds rows
[g c, (g+1) c), c = capacity // n, and per view
  1. preprocesses its own rows (with the means2D tap added to its means2D);
  2. all-gathers the compact screen-space outputs (means2D, conic, color, depth,
     opacity, features; radius, tile rect, visibility) through the differentiable
     `collectives.all_gather_rows`;
  3. bins and blends tile band g (`spatial.band_from_prep`, budget // n a band) and
     takes the band's loss, scaled so the bands' losses add up to the image's;
  4. backward: the gather's reduce-scatter returns each rank its own rows' gradients,
     summed over every band.
Adam runs on each rank's rows; with a 'data' axis the views split over it and the row
gradients and statistics are averaged / summed over it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from langsplat_tpu_torch.models.gaussian_field import GaussianField
from langsplat_tpu_torch.ops.projection import PreprocessOut
from langsplat_tpu_torch.ops.render import RenderSettings, unit_features
from langsplat_tpu_torch.parallel import collectives as col
from langsplat_tpu_torch.parallel.data_parallel import (flat_rows, local_views_grads,
                                                         tap_stats, unflat_rows)
from langsplat_tpu_torch.parallel.dp_spatial import band_loss
from langsplat_tpu_torch.parallel.spatial import (band_from_prep, band_height,
                                                  preprocess_view)
from langsplat_tpu_torch.train.densify import DensifyStats
from langsplat_tpu_torch.train.trainer import extract_params, merge_params


class GaussShardedStepOutput(NamedTuple):
    field: GaussianField
    opt_state: dict
    stats: DensifyStats
    loss: torch.Tensor
    dropped: torch.Tensor        # [] int64, summed over bands (and data rows)
    rect_dropped: torch.Tensor   # [] int64


def map_rows(tree, capacity: int | None, fn):
    """Apply `fn` to every [capacity, ...] tensor (every tensor, with capacity None) of a
    field, optimizer state, statistics, or a dict or tuple of them; other leaves (counts,
    None) pass through."""
    if isinstance(tree, torch.Tensor):
        rows = capacity is None or (tree.dim() >= 1 and tree.shape[0] == capacity)
        return fn(tree) if rows else tree
    if isinstance(tree, dict):
        return {k: map_rows(v, capacity, fn) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map_rows(v, capacity, fn) for v in tree)
    if isinstance(tree, (GaussianField, DensifyStats)):
        return type(tree)(**{k: map_rows(v, capacity, fn)
                             for k, v in vars(tree).items()})
    return tree


def shard_rows(tree, capacity: int, index: int, n: int):
    """Rows [index c, (index+1) c), c = capacity // n, of every [capacity, ...] leaf."""
    if capacity % n:
        raise ValueError(f"capacity {capacity} must divide by {n} shards")
    rows = capacity // n
    return map_rows(tree, capacity, lambda x: x[index * rows:(index + 1) * rows].clone())


def gather_rows(tree, shard_capacity: int, group=None):
    """Every rank's rows of every [shard_capacity, ...] leaf, concatenated in rank order
    (the inverse of `shard_rows` over the group)."""
    return map_rows(tree, shard_capacity, lambda x: col.all_gather_rows(x, group))


def spread_rows(tree, capacity: int, ndev: int):
    """Round-robin permute [capacity, ...] rows over the ndev contiguous row shards (old
    row i -> shard i % ndev), so that a front-packed field leaves free rows in every
    shard for shard-local densification. Apply to field, optimizer state and statistics
    together, at setup and after a capacity growth."""
    if capacity % ndev:
        raise ValueError(f"capacity {capacity} must divide by ndev {ndev}")
    rows = capacity // ndev

    def permute(x):
        j = torch.arange(capacity, device=x.device)
        return x[(j % rows) * ndev + j // rows]
    return map_rows(tree, capacity, permute)


def _prep_rows(field, settings: RenderSettings, viewmatrix, projmatrix, campos, tap):
    """(float rows [c, 10 + F] with gradients, int rows [c, 6]) of this rank's
    preprocess: means2D + tap, conic, color, depth, opacity, features; radius, tile
    rect, visibility."""
    prep = preprocess_view(field, settings, viewmatrix, projmatrix, campos)
    floats = [prep.means2d + tap, prep.conics, prep.colors, prep.depths[:, None],
              field.get_opacity]
    if settings.include_feature:
        floats.append(unit_features(field))
    ints = torch.cat([prep.radii[:, None], prep.tiles_min, prep.tiles_max,
                      prep.visible[:, None].to(torch.int32)], dim=1).to(torch.int32)
    return torch.cat(floats, dim=1), ints, prep


def _unpack(floats, ints, include_feature: bool):
    prep = PreprocessOut(means2d=floats[:, 0:2], depths=floats[:, 8], conics=floats[:, 2:5],
                         radii=ints[:, 0], colors=floats[:, 5:8], tiles_min=ints[:, 1:3],
                         tiles_max=ints[:, 3:5], visible=ints[:, 5].bool())
    return prep, floats[:, 9], floats[:, 10:] if include_feature else None


def gauss_train_step(field: GaussianField, opt_state: dict, stats: DensifyStats,
                     viewmats, projmats, campos, gts, masks, bg, *,
                     settings: RenderSettings, optimizer, include_feature: bool,
                     capacity: int, lambda_dssim: float = 0.2, gauss_group=None,
                     data_group=None) -> GaussShardedStepOutput:
    """One step with this rank's rows of the field, optimizer state and statistics
    (`shard_rows`), over this rank's views (all views on a 1-D mesh; the data row's
    views with `data_group`)."""
    n_bands, band = col.size(gauss_group), col.rank(gauss_group)
    if capacity % n_bands:
        raise ValueError(f"capacity {capacity} must divide by the gauss axis size "
                         f"{n_bands}")
    bh = band_height(settings, n_bands)
    budget = (settings.budget or 6 * capacity) // n_bands
    # (padded height / H) / n_bands: the bands' scaled losses add up to the image's
    scale = bh / settings.image_height
    device = field.device

    def render_view(f, v, tap):
        floats, ints, local = _prep_rows(f, settings, viewmats[v], projmats[v],
                                         campos[v], tap)
        full, opac, feats = _unpack(col.all_gather_rows(floats, gauss_group),
                                    col.all_gather_rows(ints, gauss_group),
                                    include_feature)
        out = band_from_prep(full, opac, feats, settings, band, n_bands, bg,
                             budget=budget)
        # the statistics read this rank's own rows
        out["radii"], out["visibility_filter"] = local.radii, local.radii > 0
        return out

    def loss_of_view(out, v):
        return band_loss(out, gts[v], masks[v], settings, band, bh, include_feature,
                         lambda_dssim) * scale

    local_loss, grads, taps, drop, rect = local_views_grads(
        field, include_feature, len(viewmats), render_view, loss_of_view)
    gnorm, denom, radii = tap_stats(taps, settings, field.capacity, device)
    counts = col.sum_(torch.stack([drop, rect]), gauss_group)
    loss = col.sum_(local_loss, gauss_group)
    sums = torch.stack([gnorm, denom])
    if data_group is not None:     # views split over 'data': join the data rows
        counts = col.sum_(counts, data_group)
        loss = col.mean(loss, data_group)
        sums = col.sum_(sums, data_group)
        radii = col.max_(radii, data_group)
        grads = unflat_rows(col.mean(flat_rows(grads), data_group), grads)

    params = extract_params(field, include_feature)
    new_params, opt_state = optimizer.update(grads, opt_state, params)
    new_stats = DensifyStats(grad_accum=stats.grad_accum + sums[0],
                             denom=stats.denom + sums[1],
                             max_radii2d=torch.maximum(stats.max_radii2d, radii))
    return GaussShardedStepOutput(merge_params(field, new_params), opt_state, new_stats,
                                  loss, counts[0], counts[1])
