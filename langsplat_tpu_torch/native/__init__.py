"""The native (host C++) language-feature loader, bound with ctypes.

PyTorch-port counterpart of `langsplat_tpu/native/`, with its own copy of the source
(`langsplat_io.cpp`): the same C ABI (`ls_gather_feature`, `ls_npy_shape`), error codes,
mmap of the npy files and threaded gather. The library is built at first use with
`g++ -O3 -std=c++17 -shared -fPIC -pthread` into `langsplat_tpu_torch/_build/`, named by
a hash of the source and the flags. Unlike the JAX package, a failed build raises with
the compiler's output instead of falling back to numpy in silence; only an input the
loader cannot serve (`gather_language_feature` returns None) goes to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "langsplat_io.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

# langsplat_io.cpp returns LS_OK or a negative code: -1 cannot open or map the file,
# -2 npy header parse error, -3 unsupported dtype or layout, -4 shape mismatch,
# -5 feature level out of range
LS_OK = 0

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"langsplat_io-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; raises RuntimeError with the compiler's
    output when g++ fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the native loader failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"building the native loader failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent process never sees a partial file
    return out


def get_library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ls_gather_feature.restype = ctypes.c_int
            lib.ls_gather_feature.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int]
            lib.ls_npy_shape.restype = ctypes.c_int
            lib.ls_npy_shape.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                         ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        return _lib


def npy_shape(path: str) -> tuple[tuple[int, ...], str] | None:
    """(shape, dtype kind + itemsize such as 'i4') from the native header parser, or
    None when the file cannot be read as an npy file."""
    shape = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int(0)
    rc = get_library().ls_npy_shape(path.encode(), shape, ctypes.byref(ndim))
    if rc < 0:
        return None
    return tuple(shape[: ndim.value]), f"{chr(rc >> 8)}{rc & 0xFF}"


def gather_language_feature(seg_path: str, feat_path: str, feature_level: int,
                            height: int, width: int, num_feat: int,
                            num_threads: int = 0
                            ) -> tuple[np.ndarray, np.ndarray] | None:
    """(feature [F, H, W] float32, mask [1, H, W] float32) with the semantics of
    `Camera.get_language_feature`, or None when the loader cannot serve this input (a
    resolution mismatch, a dtype other than int16/32/64 segments with float16/32
    features, a bad level or file). num_threads 0 means the hardware's concurrency
    (at most 16)."""
    feature = np.empty((num_feat, height, width), np.float32)
    mask = np.empty((1, height, width), np.float32)
    rc = get_library().ls_gather_feature(
        seg_path.encode(), feat_path.encode(), feature_level, height, width, num_feat,
        feature.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if rc != LS_OK:
        return None
    return feature, mask
