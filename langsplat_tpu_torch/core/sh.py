"""Real spherical-harmonics evaluation (degrees 0..4) and the RGB->SH DC conversion.

PyTorch counterpart of `langsplat_tpu/core/sh.py`: the same basis constants and the same
expression order, so float32 results agree with the JAX package to rounding.
"""

from __future__ import annotations

import torch

# Standard real-SH basis constants (identical values to every 3DGS implementation).
_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate the SH basis at unit directions.

    Args:
      degree: int in [0, 4], the *active* degree; `sh` may hold more coefficients.
      sh: [..., C, K] coefficients with K >= (degree+1)**2 (channel-major, coeff-minor).
      dirs: [..., 3] unit directions.

    Returns:
      [..., C] evaluated values (no +0.5 offset, no clamp; see `sh_to_color`).
    """
    if not (0 <= degree <= 4):
        raise ValueError(f"SH degree must be in [0,4], got {degree}")
    result = _C0 * sh[..., 0]
    if degree > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (result - _C1 * y * sh[..., 1] + _C1 * z * sh[..., 2]
                  - _C1 * x * sh[..., 3])
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result
                      + _C2[0] * xy * sh[..., 4]
                      + _C2[1] * yz * sh[..., 5]
                      + _C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                      + _C2[3] * xz * sh[..., 7]
                      + _C2[4] * (xx - yy) * sh[..., 8])
            if degree > 2:
                result = (result
                          + _C3[0] * y * (3.0 * xx - yy) * sh[..., 9]
                          + _C3[1] * xy * z * sh[..., 10]
                          + _C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11]
                          + _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12]
                          + _C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13]
                          + _C3[5] * z * (xx - yy) * sh[..., 14]
                          + _C3[6] * x * (xx - 3.0 * yy) * sh[..., 15])
                if degree > 3:
                    result = (result
                              + _C4[0] * xy * (xx - yy) * sh[..., 16]
                              + _C4[1] * yz * (3.0 * xx - yy) * sh[..., 17]
                              + _C4[2] * xy * (7.0 * zz - 1.0) * sh[..., 18]
                              + _C4[3] * yz * (7.0 * zz - 3.0) * sh[..., 19]
                              + _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0) * sh[..., 20]
                              + _C4[5] * xz * (7.0 * zz - 3.0) * sh[..., 21]
                              + _C4[6] * (xx - yy) * (7.0 * zz - 1.0) * sh[..., 22]
                              + _C4[7] * xz * (xx - 3.0 * yy) * sh[..., 23]
                              + _C4[8] * (xx * (xx - 3.0 * yy)
                                          - yy * (3.0 * xx - yy)) * sh[..., 24])
    return result


def sh_to_color(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> clamped RGB, the rasterizer's color path: max(eval_sh + 0.5, 0)."""
    return torch.clamp_min(eval_sh(degree, sh, dirs) + 0.5, 0.0)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> DC SH coefficient."""
    return (rgb - 0.5) / _C0
