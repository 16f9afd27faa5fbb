"""Dense rasterizer: the correctness oracle for the tiled blend and its CUDA kernel.

PyTorch counterpart of `langsplat_tpu/ops/rasterize_reference.py`. Evaluates every
Gaussian at every pixel (O(N*H*W)) in depth order, front to back, with the blend rules of
the 3DGS rasterizer: alpha = min(0.99, opacity * exp(power)), skip when power > 0 or
alpha < 1/255, a pixel ends once its transmittance would drop below 1e-4, and the
background is composited as C += T_final * bg on the RGB channels only. Slow by
construction: for tests and tiny scenes.
"""

from __future__ import annotations

import torch

from langsplat_tpu_torch.ops.projection import PreprocessOut

ALPHA_EPS = 1.0 / 255.0
TERM_EPS = 1e-4
ALPHA_MAX = 0.99


def blend_weights(alphas: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Front-to-back blending weights with the termination rule.

    alphas: [N, ...] per-(gaussian, pixel) alphas in depth order (invalid entries 0).
    Returns (weights [N, ...], final_transmittance [...]) with
    weights_i = alpha_i * prod_{j<i, included}(1 - alpha_j), zeroed after termination.
    """
    # Inclusion is a prefix property: gaussian i contributes iff the transmittance after
    # blending it stays >= TERM_EPS and no earlier gaussian ended the pixel; skipped
    # gaussians (alpha 0) leave T unchanged.
    t_incl = torch.cumprod(1.0 - alphas, dim=0)
    included = torch.cumprod((t_incl >= TERM_EPS).to(alphas.dtype), dim=0)
    eff_alpha = alphas * included
    t_excl = torch.cumprod(1.0 - eff_alpha, dim=0) / (1.0 - eff_alpha + 1e-20)
    weights = eff_alpha * t_excl
    t_final = torch.prod(1.0 - eff_alpha, dim=0)
    return weights, t_final


def compute_alphas(means2d: torch.Tensor, conics: torch.Tensor, opacities: torch.Tensor,
                   pix_x: torch.Tensor, pix_y: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Per-(gaussian, pixel) alpha. means2d [N,2], conics [N,3], opacities [N],
    pix_x/pix_y [...pix], valid [N] -> [N, ...pix]."""
    shape = (-1,) + (1,) * pix_x.dim()
    dx = pix_x[None] - means2d[:, 0].reshape(shape)
    dy = pix_y[None] - means2d[:, 1].reshape(shape)
    a = conics[:, 0].reshape(shape)
    b = conics[:, 1].reshape(shape)
    c = conics[:, 2].reshape(shape)
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    keep_p = (power <= 0.0) & valid.reshape(shape)
    alpha = torch.clamp_max(opacities.reshape(shape) * torch.exp(
        torch.where(keep_p, power, -1.0)), ALPHA_MAX)
    keep = keep_p & (alpha >= ALPHA_EPS)
    return torch.where(keep, alpha, 0.0)


def rasterize_dense(
    prep: PreprocessOut,
    opacities: torch.Tensor,
    features: torch.Tensor | None,
    bg: torch.Tensor,
    *,
    image_height: int,
    image_width: int,
    tile_size: int | None = None,
) -> dict:
    """Render RGB [3,H,W] (+ language feature image [F,H,W]) from preprocessed Gaussians.

    tile_size: when given, a Gaussian contributes at a pixel only if its tile rect covers
    the pixel's tile (the binned footprint); when None, it is evaluated everywhere.
    """
    order = torch.sort(torch.where(prep.visible, prep.depths, torch.inf),
                       stable=True).indices
    means2d = prep.means2d[order]
    conics = prep.conics[order]
    colors = prep.colors[order]
    opac = opacities[order]
    valid = prep.visible[order]

    ys = torch.arange(image_height, dtype=means2d.dtype, device=means2d.device)
    xs = torch.arange(image_width, dtype=means2d.dtype, device=means2d.device)
    pix_y, pix_x = torch.meshgrid(ys, xs, indexing="ij")

    alphas = compute_alphas(means2d, conics, opac, pix_x, pix_y, valid)  # [N, H, W]
    if tile_size is not None:
        ptx = (pix_x / tile_size).to(torch.int32)[None]
        pty = (pix_y / tile_size).to(torch.int32)[None]
        tmin = prep.tiles_min[order]
        tmax = prep.tiles_max[order]
        in_rect = ((ptx >= tmin[:, 0, None, None]) & (ptx < tmax[:, 0, None, None])
                   & (pty >= tmin[:, 1, None, None]) & (pty < tmax[:, 1, None, None]))
        alphas = torch.where(in_rect, alphas, 0.0)
    weights, t_final = blend_weights(alphas)

    image = torch.einsum("nhw,nc->chw", weights, colors) + t_final[None] * bg[:, None, None]
    out = {"render": image, "final_transmittance": t_final}
    if features is not None:
        out["language_feature_image"] = torch.einsum("nhw,nf->fhw", weights,
                                                     features[order])
    return out
