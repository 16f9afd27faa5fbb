"""Build and bind the port's CUDA kernels: nvcc compiles each source under `csrc/` into a
shared library with a plain C interface, loaded with ctypes.

A library is built at first use into `langsplat_tpu_torch/_build/`, named by a hash of
its sources and flags, so a changed source rebuilds and an unchanged one is reused.
Nothing here runs at import time. Every call of a kernel goes through one `Kernel`
binding: it launches the entry point on a device's current stream, raises on a failed
launch and counts it in `LAUNCHES`, per kernel (a view of the counters
`launches.<kernel>` of `utils/tracing.py`); a caller resets it to show which kernels a
run went through. `check` is the wrappers' one tensor check. `guarded` places a
kernel's output inside guard words, to show that the kernel writes nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from langsplat_tpu_torch.utils import tracing

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
#: flags of one source beyond NVCC_FLAGS: preprocess.cu, ssim.cu, binning.cu and adam.cu
#: round every + and * alone, as the plain PyTorch versions' elementwise kernels do
SOURCE_FLAGS = {"preprocess.cu": ("--fmad=false",), "ssim.cu": ("--fmad=false",),
                "binning.cu": ("--fmad=false",), "adam.cu": ("--fmad=false",)}

#: kernel name -> launches through its wrapper since the last reset
LAUNCHES = tracing.CounterView("launches.")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def nvcc_flags(source: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, ())


def library_path(source: str) -> Path:
    """Where the library for `source` (a file name under csrc/) is, or will be, built."""
    digest = hashlib.sha256(" ".join(nvcc_flags(source)).encode())
    for path in [CSRC_DIR / source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(sources: list[str]) -> list[Path]:
    """Compile the given csrc/ sources that are not built yet, one nvcc process per
    source, all started together. Returns the libraries' paths."""
    outs = [library_path(s) for s in sources]
    pending = []
    for source, out in zip(sources, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *nvcc_flags(source), "-o", str(tmp), str(CSRC_DIR / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        pending.append((source, out, tmp, proc))
    errors = []
    for source, out, tmp, proc in pending:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {source}:\n{log}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent process never sees a partial file
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def load(source: str) -> ctypes.CDLL:
    """The loaded library for csrc/`source`, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build([source])[0]))
            _libs[source] = lib
        return lib


class Kernel:
    """Entry point `name` of csrc/`source`, loaded and typed with `argtypes` at its first
    call. With `launch`, `kernel(device, *args)` passes a tensor (or None) at each pointer
    argument as its data pointer, launches on `device`'s current stream (the last C
    argument), raises RuntimeError on a nonzero CUDA error code and counts
    LAUNCHES[name]; else `kernel(*args)` returns the result."""

    def __init__(self, source: str, name: str, argtypes: list, restype=ctypes.c_int,
                 launch: bool = True):
        self.source, self.name, self.launch, self.restype = source, name, launch, restype
        self.argtypes = list(argtypes) + [ctypes.c_void_p] * launch
        self._ptrs = [t is ctypes.c_void_p for t in argtypes]   # isinstance costs more
        self._fn = None

    def __call__(self, *args):
        if self._fn is None:
            fn = getattr(load(self.source), self.name)
            fn.argtypes, fn.restype = self.argtypes, self.restype
            self._fn = fn
        if not self.launch:
            return self._fn(*args)
        device = args[0]
        args = [a.data_ptr() if p and a is not None else a
                for a, p in zip(args[1:], self._ptrs)]
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.name} kernel launch failed with CUDA error {err}")
        LAUNCHES[self.name] += 1


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device,
          contiguous: bool = True) -> None:
    """Raise ValueError unless `t` is on `device` with `dtype` and `shape` (and, with
    `contiguous`, contiguous)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


#: the bit pattern of a guard word: a NaN whose payload no arithmetic produces
GUARD_WORD = 0x7FC0FFEE


def guarded(shape, dtype: torch.dtype, device, guard_bytes: int = 1 << 16):
    """An output tensor of `shape` (a 4-byte dtype) placed as a view in the middle of one
    larger buffer, with `guard_bytes` of GUARD_WORD on each side, and a function that
    counts the guard words that no longer hold it. A kernel that wrote past either end
    of the view would change guard words there; into a tensor of its own, the caching
    allocator would let that pass without an error."""
    numel = math.prod(shape)
    guard = guard_bytes // 4
    buf = torch.full((2 * guard + numel,), GUARD_WORD, dtype=torch.int32, device=device)
    view = buf[guard:guard + numel].view(dtype).view(shape)

    def changed() -> int:
        return int((buf[:guard] != GUARD_WORD).sum()
                   + (buf[guard + numel:] != GUARD_WORD).sum())

    return view, changed
