"""Training step on a 2-D ('data', 'tiles') mesh: views split over 'data', each view's
tile bands over 'tiles'.

Counterpart of `langsplat_tpu/parallel/dp_spatial.py:47 make_dp_spatial_train_step`,
which the JAX package reaches from no CLI flag (its `__graft_entry__.py
dryrun_multichip` and tests call it); here it is a library function too. Each rank
renders its band (`spatial.render_band`) of its data row's views and takes band-local
losses: rows past the image are masked out of both sides, and the loss is rescaled by
padded_h / H so that the mean over bands is the image's per-pixel mean. L1 terms are
exact under banding; SSIM is windowed (11x11), so the band-local SSIM differs from the
image's within 5 pixels of a band boundary: an approximation the JAX package documents
and keeps (exact with lambda_dssim = 0, and for the feature phase's masked L1).
Gradients and the loss are averaged over both axes; the means2D tap's gradient is summed
over bands and divided by their count; visibility is "any band"; Adam is replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from langsplat_tpu_torch.core import losses
from langsplat_tpu_torch.ops.render import RenderSettings
from langsplat_tpu_torch.parallel import collectives as col
from langsplat_tpu_torch.parallel import mesh as mesh_lib
from langsplat_tpu_torch.parallel.data_parallel import (DpStepOutput, flat_rows,
                                                         local_views_grads, stat_scale,
                                                         unflat_rows)
from langsplat_tpu_torch.parallel.spatial import band_height, render_band
from langsplat_tpu_torch.train.densify import DensifyStats
from langsplat_tpu_torch.train.trainer import extract_params, merge_params


def _band_rows(img: torch.Tensor, y0: int, bh: int) -> torch.Tensor:
    """Rows [y0, y0 + bh) of [..., H, W], zero past H."""
    pad = max(0, y0 + bh - img.shape[-2])
    return F.pad(img, (0, 0, 0, pad))[..., y0:y0 + bh, :]


def band_loss(out: dict, gt, mask, settings: RenderSettings, band: int, bh: int,
              include_feature: bool, lambda_dssim: float):
    """The loss of band `band` of one view against the same rows of its targets, rows
    past the image masked out."""
    y0 = band * bh
    row_ok = (torch.arange(bh, device=gt.device) + y0 < settings.image_height
              ).to(gt.dtype)[:, None]
    gt_band = _band_rows(gt, y0, bh)
    if include_feature:
        mask_band = _band_rows(mask, y0, bh)
        return losses.masked_l1_loss(out["language_feature_image"] * row_ok,
                                     gt_band * row_ok, mask_band * row_ok)
    return losses.rgb_loss(out["render"] * row_ok, gt_band, lambda_dssim)


def dp_spatial_train_step(field, opt_state: dict, stats: DensifyStats, viewmats,
                          projmats, campos, gts, masks, bg, *, settings: RenderSettings,
                          optimizer, include_feature: bool, lambda_dssim: float = 0.2,
                          mesh=None, data_axis: str = "data",
                          tile_axis: str = "tiles") -> DpStepOutput:
    """One step over this rank's data row's views (sequences as in
    `data_parallel.dp_train_step`), rendering band `mesh.get_local_rank(tile_axis)`."""
    data_group = mesh_lib.axis_group(mesh, data_axis)
    tile_group = mesh_lib.axis_group(mesh, tile_axis)
    n_bands, band = col.size(tile_group), col.rank(tile_group)
    bh = band_height(settings, n_bands)
    scale = bh * n_bands / settings.image_height
    device = field.device

    def render_view(f, v, tap):
        return render_band(f, settings, band, n_bands, viewmats[v], projmats[v],
                           campos[v], bg, screenspace_offset=tap)

    def loss_of_view(out, v):
        return band_loss(out, gts[v], masks[v], settings, band, bh, include_feature,
                         lambda_dssim) * scale

    local_loss, grads, taps, drop, rect = local_views_grads(
        field, include_feature, len(viewmats), render_view, loss_of_view)

    grads = unflat_rows(col.mean(col.mean(flat_rows(grads), tile_group), data_group),
                        grads)
    loss = col.mean(col.mean(local_loss, tile_group), data_group)
    counts = col.sum_(torch.stack([drop, rect]))
    # each view's full tap gradient is the band sum over n_bands; visible in any band
    ss_all = col.sum_(torch.stack([ss for ss, _, _ in taps]), tile_group) / n_bands
    vis_all = col.sum_(torch.stack([vis for _, vis, _ in taps]).to(torch.int32),
                       tile_group) > 0
    scale2 = stat_scale(settings, device)
    visf = vis_all.to(torch.float32)
    gnorm = (torch.linalg.vector_norm(ss_all[..., :2] * scale2, dim=-1) * visf).sum(0)
    sums = col.sum_(torch.stack([gnorm, visf.sum(0)]), data_group)
    radii = torch.stack([torch.where(vis, rad.to(torch.float32), 0.0)
                         for _, vis, rad in taps]).amax(0)
    max_radii = col.max_(col.max_(radii, tile_group), data_group)

    params = extract_params(field, include_feature)
    new_params, opt_state = optimizer.update(grads, opt_state, params)
    new_stats = DensifyStats(grad_accum=stats.grad_accum + sums[0],
                             denom=stats.denom + sums[1],
                             max_radii2d=torch.maximum(stats.max_radii2d, max_radii))
    return DpStepOutput(merge_params(field, new_params), opt_state, new_stats, loss,
                        counts[0], counts[1], None)
