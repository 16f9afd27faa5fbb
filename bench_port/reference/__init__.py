"""The benchmark's plain reference of a LangSplat render and training step.

Plain PyTorch and numpy only. It imports nothing of `langsplat_tpu_torch` (nor JAX nor
`langsplat_tpu`) and takes nothing the program made: the camera matrices, the instance
lists, the gradients and the optimizer state are all worked out here again from the
inputs that the benchmark makes from the seed. The arithmetic follows the 3DGS
rasterizer's rules as the port states them (alpha = min(0.99, o exp(power)), skip below
1/255, end a pixel below T 1e-4, background on RGB only), in float32, with every tile
blended by a plain depth-step loop instead of a kernel.

`Precision` selects the arithmetic: "float32" is the reference; "bfloat16" is the
control, which rounds every stage's tensors to bfloat16 (what a program that stored its
field, screen-space attributes, images, gradients and moments in bfloat16 would
compute) and has to come out as not correct.
"""

from __future__ import annotations

import torch


class Precision:
    """Rounding applied at each stage boundary of the reference."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"precision must be float32 or bfloat16, got {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32" or x is None or not x.is_floating_point():
            return x
        return x.to(torch.bfloat16).to(x.dtype)


FLOAT32 = Precision("float32")
