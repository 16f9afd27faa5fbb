"""Per-Gaussian forward preprocess: frustum cull, projection, EWA 2D covariance, conic,
screen radius, tile rect, SH->RGB.

PyTorch counterpart of `langsplat_tpu/ops/projection.py:102 preprocess`, with the same
numeric conventions:
  - matrices are row-vector convention (`p_hom = [p,1] @ M`);
  - near-cull at view z <= 0.2; projective divide by (w + 1e-7);
  - EWA Jacobian clamps x/z and y/z to +-1.3*tanfov; +0.3 low-pass dilation on the 2D
    covariance diagonal;
  - radius = ceil(3 * sqrt(max eigenvalue)); ndc->pix v -> ((v+1)*S - 1)/2.

The K=4 and K=3 contractions are written out elementwise, as in the JAX package, so
they are exact float32 whatever the matmul precision setting (TF32 would move
projected positions by pixels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from langsplat_tpu_torch.core import sh as sh_lib
from langsplat_tpu_torch.core import transforms


class PreprocessOut(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N, ...]; padded slots are invalid)."""
    means2d: torch.Tensor    # [N, 2] pixel coords
    depths: torch.Tensor     # [N] view-space z
    conics: torch.Tensor     # [N, 3] inverse 2D covariance (a, b, c): ax^2 + 2bxy + cy^2
    radii: torch.Tensor      # [N] int32 screen radius in pixels (0 => invisible)
    colors: torch.Tensor     # [N, 3] RGB from SH (or passthrough of colors_precomp)
    tiles_min: torch.Tensor  # [N, 2] int32 inclusive (tx0, ty0)
    tiles_max: torch.Tensor  # [N, 2] int32 exclusive (tx1, ty1)
    visible: torch.Tensor    # [N] bool: survives cull and has nonzero radius


def _affine4(points: torch.Tensor, matrix: torch.Tensor, cols: int) -> torch.Tensor:
    """Row-vector transform [x y z 1] @ matrix[:, :cols] as exact-f32 elementwise ops."""
    x, y, z = points[:, 0:1], points[:, 1:2], points[:, 2:3]
    m = matrix
    return x * m[0, :cols] + y * m[1, :cols] + z * m[2, :cols] + m[3, :cols]


def project_points(means3d: torch.Tensor, viewmatrix: torch.Tensor,
                   projmatrix: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (p_view [N,3], p_ndc [N,3]). Row-vector convention."""
    p_view = _affine4(means3d, viewmatrix, 3)
    p_hom = _affine4(means3d, projmatrix, 4)
    p_ndc = p_hom[:, :3] / (p_hom[:, 3:4] + 1e-7)
    return p_view, p_ndc


def compute_cov2d(means3d: torch.Tensor, cov3d: torch.Tensor, viewmatrix: torch.Tensor,
                  tanfovx: float, tanfovy: float, focal_x: float,
                  focal_y: float) -> torch.Tensor:
    """EWA splat of the 3D covariance to screen space; returns [N, 3] (xx, xy, yy):
    cov2d = J W Sigma W^T J^T + diag(0.3, 0.3)."""
    t = _affine4(means3d, viewmatrix, 3)
    tz = t[:, 2]
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    txtz = torch.clamp(t[:, 0] / tz, -limx, limx)
    tytz = torch.clamp(t[:, 1] / tz, -limy, limy)
    tx = txtz * tz
    ty = tytz * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    zeros = torch.zeros_like(tz)
    J = [[focal_x * inv_z, zeros, -focal_x * tx * inv_z2],
         [zeros, focal_y * inv_z, -focal_y * ty * inv_z2]]

    W = viewmatrix[:3, :3].T  # world->view rotation acting on column vectors
    T = [[sum(J[i][j] * W[j, k] for j in range(3)) for k in range(3)]
         for i in range(2)]  # [2][3] of [N]
    TS = [[sum(T[i][j] * cov3d[:, j, k] for j in range(3)) for k in range(3)]
          for i in range(2)]  # T @ Sigma
    xx = sum(TS[0][k] * T[0][k] for k in range(3)) + 0.3
    xy = sum(TS[0][k] * T[1][k] for k in range(3))
    yy = sum(TS[1][k] * T[1][k] for k in range(3)) + 0.3
    return torch.stack([xx, xy, yy], dim=-1)


def _trunc_clip(x: torch.Tensor, hi: int) -> torch.Tensor:
    """int32 truncation toward zero clipped to [0, hi], defined for every float:
    NaN gives 0 and out-of-range values saturate, as XLA's conversion does (a plain
    float->int cast of NaN or of values past int32 is undefined)."""
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), -1.0, hi + 1.0)
    return torch.clamp(x.to(torch.int32), 0, hi)


def preprocess(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    shs: torch.Tensor | None,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    campos: torch.Tensor,
    *,
    image_height: int,
    image_width: int,
    tanfovx: float,
    tanfovy: float,
    sh_degree: int,
    tile_size: int,
    scale_modifier: float = 1.0,
    cov3d_precomp: torch.Tensor | None = None,
    colors_precomp: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
) -> PreprocessOut:
    """Vectorized preprocess over the (padded) Gaussian axis.

    `alive` masks padded capacity slots: dead slots come out invisible with radius 0,
    so they never enter binning or blending.
    """
    focal_x = image_width / (2.0 * tanfovx)
    focal_y = image_height / (2.0 * tanfovy)

    p_view, p_ndc = project_points(means3d, viewmatrix, projmatrix)
    depths = p_view[:, 2]
    in_front = depths > 0.2

    if cov3d_precomp is not None:
        cov3d = transforms.unstrip_symmetric(cov3d_precomp)
    else:
        cov3d = transforms.build_covariance_3d(scales, quats, scale_modifier)
    cov2d = compute_cov2d(means3d, cov3d, viewmatrix, tanfovx, tanfovy, focal_x, focal_y)

    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] ** 2
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conics = torch.stack([cov2d[:, 2] * inv_det, -cov2d[:, 1] * inv_det,
                          cov2d[:, 0] * inv_det], dim=-1)

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, mid - disc)))

    means2d = torch.stack([
        ((p_ndc[:, 0] + 1.0) * image_width - 1.0) * 0.5,
        ((p_ndc[:, 1] + 1.0) * image_height - 1.0) * 0.5,
    ], dim=-1)

    grid_x = (image_width + tile_size - 1) // tile_size
    grid_y = (image_height + tile_size - 1) // tile_size
    tmin_x = _trunc_clip((means2d[:, 0] - radius_f) / tile_size, grid_x)
    tmin_y = _trunc_clip((means2d[:, 1] - radius_f) / tile_size, grid_y)
    tmax_x = _trunc_clip(torch.floor_divide(means2d[:, 0] + radius_f + tile_size - 1,
                                            tile_size), grid_x)
    tmax_y = _trunc_clip(torch.floor_divide(means2d[:, 1] + radius_f + tile_size - 1,
                                            tile_size), grid_y)
    touches = (tmax_x - tmin_x) * (tmax_y - tmin_y) > 0

    visible = in_front & det_ok & touches
    if alive is not None:
        visible = visible & alive
    radii = _trunc_clip(torch.where(visible, radius_f, 0.0), 2**30)

    if colors_precomp is not None:
        colors = colors_precomp
    else:
        if shs is None:
            raise ValueError("either shs or colors_precomp must be given")
        dirs = means3d - campos[None, :]
        dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-12)
        colors = sh_lib.sh_to_color(sh_degree, shs.transpose(-1, -2), dirs)

    return PreprocessOut(
        means2d=means2d,
        depths=depths,
        conics=conics,
        radii=radii,
        colors=colors,
        tiles_min=torch.stack([tmin_x, tmin_y], dim=-1),
        tiles_max=torch.stack([tmax_x, tmax_y], dim=-1),
        visible=visible,
    )
