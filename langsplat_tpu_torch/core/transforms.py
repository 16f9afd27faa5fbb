"""Camera/geometry transforms and Gaussian covariance construction.

PyTorch counterpart of `langsplat_tpu/core/transforms.py`. Conventions are the same:
matrices are stored row-vector style (points transform as `p_hom @ M`), quaternions are
(w, x, y, z). The camera matrices are numpy, built once per camera on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) quaternions -> [..., 3, 3] rotation matrices (normalizes input)."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def build_covariance_3d(scales: torch.Tensor, quats: torch.Tensor,
                        scale_modifier: float = 1.0) -> torch.Tensor:
    """Per-Gaussian 3D covariance Sigma = R S S^T R^T -> [..., 3, 3].

    scales: [..., 3] activated scales; quats: [..., 4] (w,x,y,z), normalized inside.
    The 3x3 products are written out elementwise, in the JAX package's order, so no
    matmul precision setting (TF32) can touch them.
    """
    R = quat_to_rotmat(quats)
    s = scale_modifier * scales
    L = R * s[..., None, :]
    rows = [[sum(L[..., i, k] * L[..., j, k] for k in range(3)) for j in range(3)]
            for i in range(3)]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6] upper-triangular (xx, xy, xz, yy, yz, zz)."""
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def unstrip_symmetric(c6: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3] symmetric matrix (inverse of `strip_symmetric`)."""
    xx, xy, xz, yy, yz, zz = (c6[..., i] for i in range(6))
    return torch.stack([
        torch.stack([xx, xy, xz], dim=-1),
        torch.stack([xy, yy, yz], dim=-1),
        torch.stack([xz, yz, zz], dim=-1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# Camera matrices (numpy: built once on the host per camera, static per view)
# ---------------------------------------------------------------------------

def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """World->view 4x4 (column-vector convention), optionally recentring the camera.

    R is the COLMAP cam-to-world rotation (so it is transposed here), t the
    world-to-cam translation.
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        c2w = np.linalg.inv(Rt)
        c2w[:3, 3] = (c2w[:3, 3] + translate) * scale
        Rt = np.linalg.inv(c2w)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fov_x: float, fov_y: float) -> np.ndarray:
    """OpenGL-style perspective projection 4x4 (column-vector convention); view depth z
    maps to z*zfar/(zfar-znear) - zfar*znear/(zfar-znear), with w = z."""
    tan_y = np.tan(fov_y * 0.5)
    tan_x = np.tan(fov_x * 0.5)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov_to_focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * np.tan(fov / 2.0))


def focal_to_fov(focal: float, pixels: int) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))
