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
