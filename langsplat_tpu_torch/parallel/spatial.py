"""Tile-band sharding: one view rendered cooperatively, each rank blending one band of
tile rows.

Counterpart of `langsplat_tpu/parallel/spatial.py`: `band_height` (:29),
`band_from_prep` (:36), `render_band` (:97) and `make_spatial_render` (:126). Preprocess
runs with the full camera; a band is a pure index shift: means2D y and the tile rects'
rows move by the band's pixel offset, the rects are clipped to the band, and binning and
the blend (K1, with K2 and K3 behind it) run on the band-local tile grid with
`image_height` = the band's height. Each band bins against `budget // n_bands`. Rows
past the image (the padded last band, and the last tile row's overhang) render what
reaches them there, and pure background where nothing does; `spatial_render` gathers the
bands along H and cuts the image to its true height.
"""

from __future__ import annotations

import torch

from langsplat_tpu_torch.ops import projection
from langsplat_tpu_torch.ops.projection import PreprocessOut
from langsplat_tpu_torch.ops.render import RenderSettings, blend, unit_features
from langsplat_tpu_torch.ops.tiles import bin_gaussians
from langsplat_tpu_torch.parallel import collectives as col


def band_height(settings: RenderSettings, n_bands: int) -> int:
    """Pixel height of a band: the tile rows divided over the bands, rounded up."""
    return -(-settings.grid_y // n_bands) * settings.tile_size


def band_from_prep(prep: PreprocessOut, opacity: torch.Tensor,
                   features: torch.Tensor | None, settings: RenderSettings,
                   band_index: int, n_bands: int, bg: torch.Tensor, *, budget: int,
                   screenspace_offset: torch.Tensor | None = None) -> dict:
    """Bin and blend tile rows [band_index * rows, (band_index + 1) * rows) of a
    full-image preprocess `prep`, with the activated `opacity` [N] and `features`
    [N, F] or None. Returns the band's images ([C, band_h, W]), radii, visibility and
    drop counters."""
    bh = band_height(settings, n_bands)
    rows = bh // settings.tile_size
    y0 = band_index * bh
    shift = torch.tensor([0.0, float(y0)], dtype=prep.means2d.dtype,
                         device=prep.means2d.device)
    means2d = prep.means2d - shift
    tmin_y = torch.clamp(prep.tiles_min[:, 1] - band_index * rows, 0, rows)
    tmax_y = torch.clamp(prep.tiles_max[:, 1] - band_index * rows, 0, rows)
    visible = prep.visible & (tmax_y > tmin_y)
    band_prep = prep._replace(
        means2d=means2d,
        tiles_min=torch.stack([prep.tiles_min[:, 0], tmin_y], dim=1),
        tiles_max=torch.stack([prep.tiles_max[:, 0], tmax_y], dim=1),
        visible=visible, radii=torch.where(visible, prep.radii, 0))
    if screenspace_offset is not None:
        means2d = means2d + screenspace_offset
    inst = bin_gaussians(PreprocessOut(*(t.detach() for t in band_prep)),
                         grid_x=settings.grid_x, grid_y=rows, budget=budget,
                         max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
                         tile_size=settings.tile_size, opacities=opacity.detach())
    out = blend(band_prep, inst, opacity, features, bg, settings, image_height=bh,
                means2d_override=means2d)
    out["radii"] = band_prep.radii
    out["visibility_filter"] = band_prep.radii > 0
    out["instances_dropped"] = inst.dropped
    out["rect_dropped"] = inst.rect_dropped
    return out


def preprocess_view(field, settings: RenderSettings, viewmatrix, projmatrix,
                    campos) -> PreprocessOut:
    return projection.preprocess(
        field.xyz, field.get_scaling, field.rotation, field.get_features,
        viewmatrix, projmatrix, campos,
        image_height=settings.image_height, image_width=settings.image_width,
        tanfovx=settings.tanfovx, tanfovy=settings.tanfovy,
        sh_degree=settings.sh_degree, tile_size=settings.tile_size,
        scale_modifier=settings.scale_modifier, alive=field.alive)


def render_band(field, settings: RenderSettings, band_index: int, n_bands: int,
                viewmatrix, projmatrix, campos, bg,
                screenspace_offset: torch.Tensor | None = None) -> dict:
    """Render band `band_index` of `n_bands` of one view of the (whole) field."""
    prep = preprocess_view(field, settings, viewmatrix, projmatrix, campos)
    features = unit_features(field) if settings.include_feature else None
    budget = (settings.budget or 6 * field.capacity) // n_bands
    return band_from_prep(prep, field.get_opacity[:, 0], features, settings,
                          band_index, n_bands, bg, budget=budget,
                          screenspace_offset=screenspace_offset)


def gather_bands(band: torch.Tensor, height: int, group) -> torch.Tensor:
    """Band images [C, bh, W] (or [bh, W]) of every rank, in rank order along H, cut to
    `height`; differentiable."""
    if band.dim() == 2:
        return col.all_gather_rows(band, group)[:height]
    rows = col.all_gather_rows(band.transpose(0, 1), group)     # [n bh, C, W]
    return rows.transpose(0, 1)[:, :height]


def spatial_render(field, settings: RenderSettings, viewmatrix, projmatrix, campos,
                   bg, group=None) -> dict:
    """One view rendered by the ranks of `group`, rank r blending band r: the full
    `render` [3, H, W] (+ `language_feature_image`), `final_transmittance` and the drop
    counters summed over bands, on every rank. Differentiable: with the same loss on
    every rank, the group mean of the ranks' parameter gradients is the single-device
    gradient."""
    n, r = col.size(group), col.rank(group)
    out = render_band(field, settings, r, n, viewmatrix, projmatrix, campos, bg)
    h = settings.image_height
    result = {"render": gather_bands(out["render"], h, group),
              "final_transmittance": gather_bands(out["final_transmittance"], h, group)}
    if settings.include_feature:
        result["language_feature_image"] = gather_bands(out["language_feature_image"],
                                                        h, group)
    counts = col.sum_(torch.stack([out["instances_dropped"].to(torch.int64),
                                   out["rect_dropped"].to(torch.int64)]), group)
    result["instances_dropped"], result["rect_dropped"] = counts[0], counts[1]
    return result
