"""Training losses and image metrics: L1, L2, SSIM, PSNR.

PyTorch counterpart of `langsplat_tpu/core/losses.py`: the same L1/L2, PSNR over the
flattened per-image MSE, and SSIM with an 11x11 sigma-1.5 Gaussian window applied per
channel with zero ("SAME") padding, as two separable 1-D passes.

Full float32 on the card: a float32 convolution goes through cuDNN in TF32 by default
(`torch.backends.cudnn.allow_tf32`), and the SSIM map divides by (sigma1^2 + sigma2^2 +
9e-4), so a few 1e-3 of error in E[x^2] - mu^2 blows it far outside [-1, 1] (the bug
class recorded at `langsplat_tpu/core/losses.py:57-61`). So the window is applied as 11
shifted multiply-adds per pass, plain float32 arithmetic that no TF32 setting reaches.

SSIM dispatches by device, as `ops/projection.py preprocess` does: CPU tensors take the
plain version (`ssim_plain`: the shifted multiply-adds as elementwise PyTorch, autograd
for the gradient); CUDA tensors take the kernels of `csrc/ssim.cu`, two launches forward
(the map's tile sums, then their mean) and one backward, joined by `_Ssim`; anything the
kernels do not take raises. The kernels repeat the plain version's float32 arithmetic in
its order, so the SSIM map is bit-equal to it on the card; the mean and the gradient
differ by summation order only.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from langsplat_tpu_torch.ops import _build

#: the largest window radius the kernels' halo holds
MAX_RADIUS = 5
C1, C2 = 0.01 ** 2, 0.03 ** 2
_PTR, _INT, _TAPS = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
#: the number of float64 tile partials the forward writes for (planes, H, W)
_PARTIALS = _build.Kernel("ssim.cu", "ssim_partials", [_INT] * 3, ctypes.c_longlong,
                          launch=False)
_FORWARD = _build.Kernel("ssim.cu", "ssim_fwd", [_PTR] * 2 + [_INT] * 3
                         + [_TAPS, _INT, ctypes.c_float, ctypes.c_float] + [_PTR] * 4)
_BACKWARD = _build.Kernel("ssim.cu", "ssim_bwd",
                          [_PTR] * 3 + [_INT] * 3 + [_TAPS, _INT, _PTR, _PTR])


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


def ssim_map_plain(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
                   sigma: float = 1.5) -> torch.Tensor:
    """The SSIM map of [..., H, W] inputs: the plain version, on any device."""
    window = _gaussian_window(window_size, sigma)
    mu1 = _depthwise_blur(img1, window)
    mu2 = _depthwise_blur(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window) - mu1_mu2
    return ((2.0 * mu1_mu2 + C1) * (2.0 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
               sigma: float = 1.5) -> torch.Tensor:
    return torch.mean(ssim_map_plain(img1, img2, window_size, sigma))


# ---------------------------------------------------------------------------
# The kernels of csrc/ssim.cu
# ---------------------------------------------------------------------------

def check_ssim_inputs(img1: torch.Tensor, img2: torch.Tensor, window_size: int) -> None:
    """Raise on inputs the kernels do not take: float32 [C, H, W] or [B, C, H, W] CUDA
    tensors of one shape on one device, img2 not requiring grad, and an odd window of at
    most 2 * MAX_RADIUS + 1 taps."""
    if img1.device.type != "cuda" or img2.device != img1.device:
        raise ValueError(f"the SSIM kernels need both images on one CUDA device, got "
                         f"{img1.device} and {img2.device}")
    for name, t in (("img1", img1), ("img2", img2)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} has dtype {t.dtype}, expected torch.float32")
    if img1.shape != img2.shape or img1.dim() not in (3, 4) or img1.numel() == 0:
        raise ValueError(f"the SSIM kernels take two non-empty images of one shape "
                         f"[C, H, W] or [B, C, H, W], got {tuple(img1.shape)} and "
                         f"{tuple(img2.shape)}")
    if img2.requires_grad:
        raise ValueError("img2 requires grad; the SSIM kernels give img1's gradient only")
    if window_size % 2 != 1 or not 1 <= window_size <= 2 * MAX_RADIUS + 1:
        raise ValueError(f"the SSIM kernels take an odd window of 1 to "
                         f"{2 * MAX_RADIUS + 1} taps, got {window_size}")


@functools.lru_cache(maxsize=8)
def _taps(window_size: int, sigma: float):
    window = _gaussian_window(window_size, sigma)
    return (ctypes.c_float * len(window))(*window)


def _planes(img: torch.Tensor) -> tuple[int, int, int]:
    """(planes, H, W): the batch and channel axes are one axis of planes."""
    return math.prod(img.shape[:-2]), img.shape[-2], img.shape[-1]


def ssim_forward_cuda(img1, img2, window_size: int, sigma: float, *, save: bool,
                      want_map: bool = False) -> tuple:
    """Launch the forward kernels on contiguous inputs that `check_ssim_inputs` takes:
    (mean, derivative maps [3, *img1.shape] when `save`, else None, the SSIM map when
    `want_map`, else None)."""
    check_ssim_inputs(img1, img2, window_size)
    if not (img1.is_contiguous() and img2.is_contiguous()):
        raise ValueError("the SSIM kernels take contiguous images")
    planes, h, w = _planes(img1)
    count = _PARTIALS(planes, h, w)
    device, f32 = img1.device, torch.float32
    partials = torch.empty((count,), dtype=torch.float64, device=device)
    mean = torch.empty((), dtype=f32, device=device)
    dmaps = torch.empty((3, *img1.shape), dtype=f32, device=device) if save else None
    ssim_map = torch.empty_like(img1) if want_map else None
    _FORWARD(device, img1, img2, planes, h, w, _taps(window_size, sigma),
             window_size // 2, C1, C2, partials, mean, ssim_map, dmaps)
    return mean, dmaps, ssim_map


def ssim_backward_cuda(img1, img2, dmaps, window_size: int, sigma: float,
                       grad_out) -> torch.Tensor:
    """Launch the backward kernel: dL/dimg1 from the forward's derivative maps and the
    mean's incoming gradient (a float32 scalar, read on the device)."""
    if grad_out.dtype != torch.float32 or grad_out.numel() != 1:
        raise ValueError(f"the SSIM mean's gradient has dtype {grad_out.dtype} and shape "
                         f"{tuple(grad_out.shape)}")
    planes, h, w = _planes(img1)
    grad_out = grad_out.contiguous()
    grad1 = torch.empty_like(img1)
    _BACKWARD(img1.device, img1, img2, dmaps, planes, h, w, _taps(window_size, sigma),
              window_size // 2, grad_out, grad1)
    return grad1


class _Ssim(torch.autograd.Function):
    """Mean SSIM: the forward kernels, and the backward kernel for img1 (the derivative
    maps are written and saved only when `save`)."""

    @staticmethod
    def forward(ctx, img1, img2, window_size, sigma, save):
        mean, dmaps, _ = ssim_forward_cuda(img1, img2, window_size, sigma, save=save)
        ctx.window = (window_size, sigma)
        if save:
            ctx.save_for_backward(img1, img2, dmaps)
        return mean

    @staticmethod
    def backward(ctx, grad_out):
        img1, img2, dmaps = ctx.saved_tensors
        return (ssim_backward_cuda(img1, img2, dmaps, *ctx.window, grad_out),
                None, None, None, None)


def ssim_map_cuda(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
                  sigma: float = 1.5) -> torch.Tensor:
    """The forward kernel's SSIM map (no gradient), to hold against `ssim_map_plain`."""
    with torch.no_grad():
        return ssim_forward_cuda(img1.contiguous(), img2.contiguous(), window_size, sigma,
                                 save=False, want_map=True)[2]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over the image; inputs [C, H, W] (or batched [B, C, H, W]) in [0,1].
    CPU tensors take the plain version. CUDA tensors (either image) take the kernels,
    read through `.contiguous()`: two launches forward and, when img1 requires grad,
    one in the backward; what `check_ssim_inputs` refuses raises."""
    if "cuda" not in (img1.device.type, img2.device.type):
        return ssim_plain(img1, img2, window_size, sigma)
    save = torch.is_grad_enabled() and img1.requires_grad
    return _Ssim.apply(img1.contiguous(), img2.contiguous(), window_size, sigma, save)


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor, lambda_dssim: float = 0.2) -> torch.Tensor:
    """Phase-A photometric loss: (1-l)*L1 + l*(1-SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, gt) + lambda_dssim * (1.0 - ssim(pred, gt))


def masked_l1_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Phase-B feature loss: L1 over mask-multiplied maps, divided by the full pixel
    count (a plain mean of the masked tensors), as the JAX package does."""
    return torch.mean(torch.abs(pred * mask - gt * mask))
