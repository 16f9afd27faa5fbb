"""langsplat_tpu_torch: the PyTorch and CUDA port of langsplat_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (core/, ops/, models/, data/, cli/, train/,
evaluation/), imports nothing of it, and runs its entry points on the CUDA card unless
the caller asks for the CPU. The kernels live in csrc/ and are built with nvcc at first
use.
"""
