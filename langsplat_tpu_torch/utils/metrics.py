"""Image quality metrics: PSNR and SSIM (re-exported from `core/losses.py`) and LPIPS.

PyTorch-port counterpart of `langsplat_tpu/utils/metrics.py`. LPIPS is the distance of
unit-normalized deep features from a backbone, weighted per channel by the richzhang
"lin" layers, averaged over space and summed over layers. The distance arithmetic works
on tensors of any device. The `LPIPS` class needs torchvision and the backbone's
weights on local disk, neither of which this repository holds, so it raises without
them, as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from langsplat_tpu_torch.core.losses import psnr, ssim  # noqa: F401  (re-export)

_IMAGENET_SHIFT = (-0.030, -0.088, -0.188)
_IMAGENET_SCALE = (0.458, 0.448, 0.450)


def normalize_tensor(feats: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalize over the channel axis (richzhang normalize_tensor)."""
    norm = torch.sqrt(torch.sum(feats ** 2, dim=-3, keepdim=True))
    return feats / (norm + eps)


def lpips_distance(feats_a: list[torch.Tensor], feats_b: list[torch.Tensor],
                   lin_weights: list[torch.Tensor]) -> torch.Tensor:
    """LPIPS from per-layer features [C,H,W] and lin weights [C] (negatives clipped)."""
    total = 0.0
    for fa, fb, w in zip(feats_a, feats_b, lin_weights):
        diff = (normalize_tensor(fa) - normalize_tensor(fb)) ** 2
        w = torch.clamp_min(w.to(diff.device, diff.dtype), 0.0)
        weighted = torch.sum(w[:, None, None] * diff, dim=-3)
        total = total + torch.mean(weighted, dim=(-2, -1))
    return total


def scale_image_for_lpips(image: torch.Tensor) -> torch.Tensor:
    """[3,H,W] in [0,1] -> the ImageNet-shifted input the LPIPS backbones expect."""
    shift = torch.tensor(_IMAGENET_SHIFT, dtype=image.dtype, device=image.device)
    scale = torch.tensor(_IMAGENET_SCALE, dtype=image.dtype, device=image.device)
    return (image * 2.0 - 1.0 - shift[:, None, None]) / scale[:, None, None]


def load_richzhang_lin(weights_path: str) -> list[torch.Tensor]:
    """Per-layer lin weights [C] (CPU float32 tensors, in layer order) from a richzhang
    lpips/weights/v0.1/<net>.pth state dict (`lin{i}.model.1.weight` of shape
    [1, C, 1, 1]) or from an npz (its arrays in sorted-name order)."""
    if weights_path.endswith((".pth", ".pt")):
        sd = torch.load(weights_path, map_location="cpu", weights_only=True)
        keys = sorted((k for k in sd if k.endswith(".weight")),
                      key=lambda k: int(k.split(".")[0][3:]))
        if not keys:
            raise ValueError(f"no lin weights in {weights_path}")
        return [sd[k].reshape(-1).to(torch.float32) for k in keys]
    with np.load(weights_path) as data:
        return [torch.as_tensor(data[k]) for k in sorted(data.files)]


class LPIPS:
    """LPIPS with a torchvision backbone, net_type "alex", "vgg" or "squeeze", on
    `device` (None: the CUDA card, raising without one). Raises RuntimeError without
    torchvision or its backbone weights, and when called without lin weights unless
    `allow_uniform_lin`."""

    def __init__(self, net_type: str = "alex", weights_dir: str | None = None,
                 allow_uniform_lin: bool = False, device=None):
        self.allow_uniform_lin = allow_uniform_lin
        try:
            import torchvision.models as tvm
        except ImportError as e:
            raise RuntimeError("torchvision is not installed; LPIPS needs its backbone "
                               "weights") from e
        from langsplat_tpu_torch.device import resolve_device
        self.device = resolve_device(device)
        factory = {"alex": tvm.alexnet, "vgg": tvm.vgg16,
                   "squeeze": tvm.squeezenet1_1}[net_type]
        try:
            net = factory(weights="DEFAULT")
        except Exception as e:   # torchvision's download or cache miss, whatever its type
            raise RuntimeError(
                "torchvision backbone weights unavailable offline; pass features "
                "through lpips_distance instead") from e
        self.features = net.features.eval().to(self.device)
        self.slices = {"alex": (2, 5, 8, 10, 12), "vgg": (4, 9, 16, 23, 30),
                       "squeeze": (2, 5, 8, 10, 11, 12, 13)}[net_type]
        self.lin = load_richzhang_lin(weights_dir) if weights_dir else None

    @torch.no_grad()
    def extract(self, image) -> list[torch.Tensor]:
        """The backbone's features [C,H,W] at each slice end, on the metric's device."""
        h = scale_image_for_lpips(torch.as_tensor(image, dtype=torch.float32)
                                  .to(self.device))[None]
        layers = list(self.features)
        feats, prev = [], 0
        for end in self.slices:
            for layer in layers[prev:end]:
                h = layer(h)
            feats.append(h[0])
            prev = end
        return feats

    def __call__(self, img_a, img_b) -> float:
        fa, fb = self.extract(img_a), self.extract(img_b)
        lin = self.lin
        if lin is None:
            # uniform lin weights are not LPIPS: the metric is defined by the trained
            # per-channel weights, so never return a plausible but wrong number silently
            if not self.allow_uniform_lin:
                raise RuntimeError(
                    "no lin weights loaded (pass weights_dir with the richzhang .pth or "
                    "an npz); uniform weights are not LPIPS: opt in with "
                    "allow_uniform_lin=True for the unweighted feature distance")
            import warnings
            warnings.warn("LPIPS running with UNIFORM lin weights: this is the "
                          "unweighted feature distance, not LPIPS", stacklevel=2)
            lin = [torch.ones(f.shape[0], device=f.device) / f.shape[0] for f in fa]
        return float(lpips_distance(fa, fb, lin))
