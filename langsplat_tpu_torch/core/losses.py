"""Training losses and image metrics: L1, L2, SSIM, PSNR.

PyTorch counterpart of `langsplat_tpu/core/losses.py`: the same L1/L2, PSNR over the
flattened per-image MSE, and SSIM with an 11x11 sigma-1.5 Gaussian window applied per
channel with zero ("SAME") padding, as two separable 1-D passes.

Full float32 on the card: a float32 convolution goes through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32`), and the SSIM map divides by (sigma1^2 + sigma2^2 +
9e-4), so a few 1e-3 of error in E[x^2] - mu^2 blows it far outside [-1, 1] (the bug
class recorded at `langsplat_tpu/core/losses.py:57-61`). So the window is applied as 11
shifted multiply-adds per pass, plain float32 elementwise arithmetic that no TF32
setting reaches, forward and backward.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image PSNR; inputs [..., C, H, W] in [0,1]. Returns [...] (batch dims kept)."""
    mse = torch.mean((pred - target) ** 2, dim=(-3, -2, -1))
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse + 1e-20))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> tuple[float, ...]:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return tuple((g / g.sum()).astype(np.float32).tolist())


def _blur_axis(img: torch.Tensor, window: tuple[float, ...], dim: int) -> torch.Tensor:
    """Zero-padded 1-D correlation of `img` with `window` along `dim` (-1 or -2)."""
    k = len(window)
    r = k // 2
    pad = (r, r, 0, 0) if dim == -1 else (0, 0, r, r)
    padded = torch.nn.functional.pad(img, pad)
    size = img.shape[dim]
    out = window[0] * padded.narrow(dim, 0, size)
    for i in range(1, k):
        out = out + window[i] * padded.narrow(dim, i, size)
    return out


def _depthwise_blur(img: torch.Tensor, window: tuple[float, ...]) -> torch.Tensor:
    """Per-channel separable Gaussian blur of [..., H, W] with zero padding."""
    return _blur_axis(_blur_axis(img, window, -2), window, -1)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over the image; inputs [C, H, W] (or batched [B, C, H, W]) in [0,1]."""
    window = _gaussian_window(window_size, sigma)
    mu1 = _depthwise_blur(img1, window)
    mu2 = _depthwise_blur(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2) -> torch.Tensor:
    """Phase-A photometric loss: (1-l)*L1 + l*(1-SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (1.0 - ssim(pred, gt))


def masked_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Phase-B feature loss: L1 over mask-multiplied maps, divided by the full pixel
    count (a plain mean of the masked tensors), as the JAX package does."""
    return torch.mean(torch.abs(pred * mask - gt * mask))
