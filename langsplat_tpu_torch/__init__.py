"""langsplat_tpu_torch: the PyTorch and CUDA port of langsplat_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (core/, ops/, models/, data/, cli/, train/), imports
nothing of it, and runs its entry points on the CUDA card unless the caller asks for the
CPU. The blend kernel lives in csrc/ and is built with nvcc at first use.
"""
