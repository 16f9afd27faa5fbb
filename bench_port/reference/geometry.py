"""Cameras, covariances, spherical harmonics and the per-Gaussian projection, in plain
PyTorch and numpy.

Row-vector matrices (points transform as `[p, 1] @ M`), (w, x, y, z) quaternions,
near-cull at view z <= 0.2, projective divide by (w + 1e-7), the EWA Jacobian clamped
at 1.3 tan(fov), +0.3 on the 2D covariance diagonal, radius ceil(3 sqrt(max
eigenvalue)), pixel v = ((ndc + 1) S - 1) / 2. Every small contraction is written out
elementwise, so no TF32 setting reaches it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class View(NamedTuple):
    """One camera as the reference uses it."""
    viewmatrix: torch.Tensor   # [4, 4] world -> view, row-vector
    projmatrix: torch.Tensor   # [4, 4] world -> clip, row-vector
    campos: torch.Tensor       # [3]
    width: int
    height: int
    tanfovx: float
    tanfovy: float


def view_of(w2c_rotation: np.ndarray, w2c_translation: np.ndarray, fov_x: float,
            fov_y: float, width: int, height: int, device) -> View:
    """The matrices of a camera given by its world -> camera rotation and translation
    (COLMAP convention: x right, y down, z forward). The world -> view matrix goes
    through the camera-to-world inverse and back, as 3DGS's getWorld2View2 does with a
    zero recentring, in float64."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = w2c_rotation
    rt[:3, 3] = w2c_translation
    rt[3, 3] = 1.0
    view = np.linalg.inv(np.linalg.inv(rt)).T.astype(np.float32)
    tan_x, tan_y = math.tan(fov_x * 0.5), math.tan(fov_y * 0.5)
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = 1.0 / tan_x
    proj[1, 1] = 1.0 / tan_y
    proj[2, 2] = ZFAR / (ZFAR - ZNEAR)
    proj[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    proj[3, 2] = 1.0
    full = (view @ proj.T).astype(np.float32)
    campos = np.linalg.inv(view)[3, :3].astype(np.float32)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return View(as_t(view), as_t(full), as_t(campos), width, height, float(tan_x),
                float(tan_y))


def rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [[1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)],
            [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)],
            [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def covariance(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S^T R^T, [N, 3, 3]."""
    lmat = rotmat(quats) * scales[..., None, :]
    rows = [[sum(lmat[..., i, k] * lmat[..., j, k] for k in range(3)) for j in range(3)]
            for i in range(3)]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def sh_color(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """max(SH(dirs) + 0.5, 0) for sh [N, C, K] (channel-major), degrees 0-3."""
    if not 0 <= degree <= 3:
        raise ValueError(f"the reference evaluates SH degrees 0-3, got {degree}")
    out = SH_C0 * sh[..., 0]
    if degree > 0:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        out = out - SH_C1 * y * sh[..., 1] + SH_C1 * z * sh[..., 2] - SH_C1 * x * sh[..., 3]
        if degree > 1:
            xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
            out = (out + SH_C2[0] * xy * sh[..., 4] + SH_C2[1] * yz * sh[..., 5]
                   + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                   + SH_C2[3] * xz * sh[..., 7] + SH_C2[4] * (xx - yy) * sh[..., 8])
            if degree > 2:
                out = (out + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9]
                       + SH_C3[1] * xy * z * sh[..., 10]
                       + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11]
                       + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12]
                       + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13]
                       + SH_C3[5] * z * (xx - yy) * sh[..., 14]
                       + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15])
    return torch.clamp_min(out + 0.5, 0.0)


class Projected(NamedTuple):
    means2d: torch.Tensor    # [N, 2]
    depths: torch.Tensor     # [N]
    conics: torch.Tensor     # [N, 3]
    radii: torch.Tensor      # [N] int32
    colors: torch.Tensor     # [N, 3]
    tiles_min: torch.Tensor  # [N, 2] int32
    tiles_max: torch.Tensor  # [N, 2] int32
    visible: torch.Tensor    # [N] bool


def _affine(p: torch.Tensor, m: torch.Tensor, cols: int) -> torch.Tensor:
    return p[:, 0:1] * m[0, :cols] + p[:, 1:2] * m[1, :cols] + p[:, 2:3] * m[2, :cols] \
        + m[3, :cols]


def _trunc_clip(x: torch.Tensor, hi: int) -> torch.Tensor:
    x = torch.clamp(torch.nan_to_num(x, nan=0.0), -1.0, hi + 1.0)
    return torch.clamp(x.to(torch.int32), 0, hi)


def project(xyz, scales, quats, shs, alive, view: View, sh_degree: int,
            tile_size: int) -> Projected:
    """The per-Gaussian screen-space quantities of one view (`shs` [N, K, 3])."""
    w, h = view.width, view.height
    focal_x = w / (2.0 * view.tanfovx)
    focal_y = h / (2.0 * view.tanfovy)
    vm, pm = view.viewmatrix, view.projmatrix
    t = _affine(xyz, vm, 3)
    p_hom = _affine(xyz, pm, 4)
    p_ndc = p_hom[:, :3] / (p_hom[:, 3:4] + 1e-7)
    depths = t[:, 2]

    cov3 = covariance(scales, quats)
    tz = t[:, 2]
    limx, limy = 1.3 * view.tanfovx, 1.3 * view.tanfovy
    tx = torch.clamp(t[:, 0] / tz, -limx, limx) * tz
    ty = torch.clamp(t[:, 1] / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(tz)
    jac = [[focal_x * inv_z, zero, -focal_x * tx * inv_z2],
           [zero, focal_y * inv_z, -focal_y * ty * inv_z2]]
    rot = vm[:3, :3].T
    tm = [[sum(jac[i][j] * rot[j, k] for j in range(3)) for k in range(3)]
          for i in range(2)]
    ts = [[sum(tm[i][j] * cov3[:, j, k] for j in range(3)) for k in range(3)]
          for i in range(2)]
    cxx = sum(ts[0][k] * tm[0][k] for k in range(3)) + 0.3
    cxy = sum(ts[0][k] * tm[1][k] for k in range(3))
    cyy = sum(ts[1][k] * tm[1][k] for k in range(3)) + 0.3

    det = cxx * cyy - cxy ** 2
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conics = torch.stack([cyy * inv_det, -cxy * inv_det, cxx * inv_det], dim=-1)
    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(mid + disc, mid - disc)))
    means2d = torch.stack([((p_ndc[:, 0] + 1.0) * w - 1.0) * 0.5,
                           ((p_ndc[:, 1] + 1.0) * h - 1.0) * 0.5], dim=-1)

    gx, gy = -(-w // tile_size), -(-h // tile_size)
    x0 = _trunc_clip((means2d[:, 0] - radius) / tile_size, gx)
    y0 = _trunc_clip((means2d[:, 1] - radius) / tile_size, gy)
    x1 = _trunc_clip(torch.floor_divide(means2d[:, 0] + radius + tile_size - 1,
                                        tile_size), gx)
    y1 = _trunc_clip(torch.floor_divide(means2d[:, 1] + radius + tile_size - 1,
                                        tile_size), gy)
    visible = (depths > 0.2) & det_ok & ((x1 - x0) * (y1 - y0) > 0) & alive
    radii = _trunc_clip(torch.where(visible, radius, 0.0), 2 ** 30)

    dirs = xyz - view.campos[None, :]
    dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True) + 1e-12)
    colors = sh_color(sh_degree, shs.transpose(-1, -2), dirs)
    return Projected(means2d, depths, conics, radii, colors,
                     torch.stack([x0, y0], dim=-1), torch.stack([x1, y1], dim=-1),
                     visible)
