"""Device selection for the port's entry points: the card unless the caller asks for
the CPU, and never a quiet fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card, and raises when there is none; anything else (for
    example "cpu") is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (--device cpu on "
                "the command line) to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def float32_matmul_highest() -> None:
    """Run float32 matrix products in full float32 on the card, never as TF32. The
    autoencoder's codes and the eval's relevancy go through a temperature-10 softmax
    and thresholds (0.4, 0.5) that the reference compares at float32; TF32 keeps 10
    mantissa bits and would move them. The JAX package asks for Precision.HIGHEST on
    the same products."""
    torch.set_float32_matmul_precision("highest")
