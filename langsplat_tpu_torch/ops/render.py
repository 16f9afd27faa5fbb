"""Top-level differentiable render of one view: preprocess -> binning -> tile blend.

PyTorch counterpart of `langsplat_tpu/ops/render.py`. Returns the same dict: `render`
[3,H,W], `language_feature_image` [F,H,W] (a [1,H,W] zero image without features),
`final_transmittance`, `radii`, `visibility_filter` and the two drop counters that tell
the caller to grow the instance budget or the per-Gaussian tile cap. Gradients flow
through the blend and the preprocess into the field's parameters; binning runs on
detached inputs. The blend is `rasterize_cuda.rasterize` (backend "cuda": the kernels
on the card, their plain versions on the CPU) or `rasterize_tiled.rasterize_tiled`
(backend "tiled", at most `max_per_tile` instances a tile, on any device). `screenspace_offset` is the means2D
gradient tap: pass zeros [cap, 2] that require grad and read their gradient to drive
densification statistics.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from langsplat_tpu_torch.core import sh as sh_lib
from langsplat_tpu_torch.ops import projection
from langsplat_tpu_torch.ops.projection import PreprocessOut
from langsplat_tpu_torch.ops.rasterize_cuda import rasterize
from langsplat_tpu_torch.ops.rasterize_tiled import rasterize_tiled
from langsplat_tpu_torch.ops.tiles import bin_gaussians, instance_counts


@dataclass(frozen=True)
class RenderSettings:
    """Rasterization settings for one view."""
    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    sh_degree: int          # ACTIVE degree
    scale_modifier: float = 1.0
    include_feature: bool = True
    tile_size: int = 16
    budget: int = 0         # instance budget; 0 => 6 * capacity
    max_tiles_per_gaussian: int = 32
    backend: str = "cuda"   # "cuda" | "tiled" (rasterize_tiled, capped at max_per_tile)
    max_per_tile: int = 1024
    grad_mode: str = "full"  # "feature": the backward computes only the language-
                             # feature gradients (the feature phase freezes geometry)
    # the 3DGS convert_SHs_python / compute_cov3D_python cross-check paths: compute
    # SH colors / 3D covariances at the model layer and pass them in precomputed
    convert_shs_python: bool = False
    compute_cov3d_python: bool = False

    @property
    def grid_x(self) -> int:
        return -(-self.image_width // self.tile_size)

    @property
    def grid_y(self) -> int:
        return -(-self.image_height // self.tile_size)


def render(
    field,                        # GaussianField (or anything with its properties)
    settings: RenderSettings,
    viewmatrix: torch.Tensor,     # [4,4] row-vector world->view
    projmatrix: torch.Tensor,     # [4,4] row-vector world->clip (view @ proj)
    campos: torch.Tensor,         # [3]
    bg_color: torch.Tensor,       # [3]
    screenspace_offset: torch.Tensor | None = None,   # [cap, 2] zeros (grad tap)
    override_color: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
) -> dict[str, Any]:
    cap = field.xyz.shape[0]
    budget = settings.budget or 6 * cap

    if settings.compute_cov3d_python and cov3d_precomp is None:
        cov3d_precomp = field.get_covariance(settings.scale_modifier)
    if settings.convert_shs_python and override_color is None:
        dirs = field.xyz - campos[None, :]
        dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-12)
        override_color = sh_lib.sh_to_color(
            settings.sh_degree, field.get_features.transpose(-1, -2), dirs)

    prep = projection.preprocess(
        field.xyz,
        field.get_scaling,
        field.rotation,
        None if override_color is not None else field.get_features,
        viewmatrix, projmatrix, campos,
        image_height=settings.image_height,
        image_width=settings.image_width,
        tanfovx=settings.tanfovx,
        tanfovy=settings.tanfovy,
        sh_degree=settings.sh_degree,
        tile_size=settings.tile_size,
        scale_modifier=settings.scale_modifier,
        cov3d_precomp=cov3d_precomp,
        colors_precomp=override_color,
        alive=field.alive,
    )

    means2d = prep.means2d
    if screenspace_offset is not None:
        means2d = means2d + screenspace_offset

    features = unit_features(field) if settings.include_feature else None
    opac = field.get_opacity[:, 0]
    inst = bin_gaussians(
        PreprocessOut(*(t.detach() for t in prep)),
        grid_x=settings.grid_x, grid_y=settings.grid_y,
        budget=budget, max_tiles_per_gaussian=settings.max_tiles_per_gaussian,
        tile_size=settings.tile_size, opacities=opac.detach())
    out = blend(prep, inst, opac, features, bg_color, settings, means2d_override=means2d)

    out["radii"] = prep.radii
    out["visibility_filter"] = prep.radii > 0
    out["instances_dropped"] = inst.dropped          # budget overflow: grow budget
    out["rect_dropped"] = inst.rect_dropped          # tmax overflow: grow max_tiles
    if "language_feature_image" not in out:
        out["language_feature_image"] = torch.zeros(
            (1,) + out["render"].shape[1:], dtype=out["render"].dtype,
            device=out["render"].device)
    return out


def unit_features(field) -> torch.Tensor:
    """The field's language features scaled to unit length, as the blend takes them."""
    lf = field.get_language_feature
    # epsilon inside the sqrt: keeps the gradient finite at lf == 0
    norm = torch.sqrt(torch.sum(lf * lf, dim=-1, keepdim=True) + 1e-18)
    return lf / (norm + 1e-9)


def blend(prep: PreprocessOut, inst, opacities, features, bg, settings: RenderSettings,
          *, image_height: int | None = None,
          means2d_override: torch.Tensor | None = None) -> dict:
    """The tile blend of binned instances with `settings.backend`: "cuda"
    (`rasterize_cuda.rasterize`) or "tiled"; `image_height` overrides the settings' (a
    band of tile rows)."""
    kw = dict(image_height=image_height or settings.image_height,
              image_width=settings.image_width, tile_size=settings.tile_size,
              means2d_override=means2d_override, grad_mode=settings.grad_mode)
    if settings.backend == "tiled":
        return rasterize_tiled(prep, inst, opacities, features, bg,
                               max_per_tile=settings.max_per_tile, **kw)
    if settings.backend == "cuda":
        return rasterize(prep, inst, opacities, features, bg, **kw)
    raise ValueError(f"backend must be 'cuda' or 'tiled', got {settings.backend!r}")


def count_instances(field, settings: RenderSettings, viewmatrix, projmatrix,
                    campos) -> int:
    """Instance count (after the max_tiles cap) a render of this view would bin: a
    preprocess-only probe that sizes the instance budget."""
    cap = field.xyz.shape[0]
    prep = projection.preprocess(
        field.xyz, field.get_scaling, field.rotation, None,
        viewmatrix, projmatrix, campos,
        image_height=settings.image_height, image_width=settings.image_width,
        tanfovx=settings.tanfovx, tanfovy=settings.tanfovy,
        sh_degree=0, tile_size=settings.tile_size,
        scale_modifier=settings.scale_modifier,
        colors_precomp=torch.zeros((cap, 3), dtype=torch.float32, device=field.xyz.device),
        alive=field.alive)
    count = instance_counts(prep, tile_size=settings.tile_size,
                            tmax=settings.max_tiles_per_gaussian,
                            opacities=field.get_opacity[:, 0])
    return int(count.sum())
