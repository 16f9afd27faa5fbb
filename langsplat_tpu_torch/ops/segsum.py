"""Bounded segment sum: the CUDA kernel `csrc/segsum.cu`, its wrapper, and its plain
PyTorch version.

Port of `langsplat_tpu/ops/segsum_pallas.py:89 segment_sum_bounded` (its kernel `_kernel`,
`:42`): out[:, g] = d_pre[:, ends[g]:ends[g+1]].sum(axis=1). The blend backward writes
each instance's gradient sums into the instance's Gaussian-major (pre-sort) slot, so
this reduces them to per-Gaussian gradients.

Dispatch is by device only: tensors on the CPU go to the plain version, tensors on a
CUDA device go to the kernel, and anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from langsplat_tpu_torch.ops import _build

_SOURCE = "segsum.cu"


def _check_ends(d_pre: torch.Tensor, ends: torch.Tensor, n_out: int) -> None:
    if d_pre.dim() != 2:
        raise ValueError(f"d_pre must be [rows, width], got {tuple(d_pre.shape)}")
    if tuple(ends.shape) != (n_out + 1,):
        raise ValueError(f"ends has shape {tuple(ends.shape)}, expected ({n_out + 1},)")


def segment_sum_plain(d_pre: torch.Tensor, ends: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain PyTorch version of `segment_sum` (same arguments and result): each column
    of the covered span is added into its segment's output column, in column order."""
    _check_ends(d_pre, ends, n_out)
    ends = ends.to(torch.int64)
    lengths = ends[1:] - ends[:-1]
    seg = torch.repeat_interleave(torch.arange(n_out, device=d_pre.device), lengths)
    span = d_pre[:, int(ends[0]):int(ends[0]) + seg.shape[0]]
    out = torch.zeros((d_pre.shape[0], n_out), dtype=d_pre.dtype, device=d_pre.device)
    return out.index_add_(1, seg, span)


def segment_sum_cuda(d_pre: torch.Tensor, ends: torch.Tensor, n_out: int) -> torch.Tensor:
    """Launch the segment-sum kernel on the tensors' CUDA device and current stream."""
    device = d_pre.device
    if device.type != "cuda" or ends.device != device:
        raise ValueError(f"segment_sum_cuda needs CUDA tensors on one device, got "
                         f"{device} and {ends.device}")
    _check_ends(d_pre, ends, n_out)
    if d_pre.dtype != torch.float32 or not d_pre.is_contiguous():
        raise ValueError("d_pre must be contiguous float32")
    if ends.dtype != torch.int32 or not ends.is_contiguous():
        raise ValueError("ends must be contiguous int32")
    if d_pre.data_ptr() % 16:
        raise ValueError("d_pre must start 16-byte aligned (the kernel copies it in "
                         "16-byte words)")
    rows, width = d_pre.shape
    lib = _build.load(_SOURCE)
    fn = lib.segsum
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.empty((rows, n_out), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(d_pre.data_ptr(), ends.data_ptr(), rows, width, n_out, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"segsum kernel launch failed with CUDA error {err}")
    _build.LAUNCHES["segsum"] += 1
    return out


def segment_sum(d_pre: torch.Tensor, ends: torch.Tensor, n_out: int) -> torch.Tensor:
    """out [rows, n_out] with out[:, g] = d_pre[:, ends[g]:ends[g+1]].sum(1); `ends`
    [n_out + 1] is monotone with values in [0, d_pre.shape[1]]. CPU tensors take the
    plain version; CUDA tensors take the kernel."""
    fn = segment_sum_cuda if d_pre.device.type == "cuda" else segment_sum_plain
    return fn(d_pre, ends, n_out)
