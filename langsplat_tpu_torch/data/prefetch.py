"""Host-side data pipeline for the feature phase: a device LRU cache and a
language-feature prefetcher.

PyTorch counterpart of `langsplat_tpu/data/prefetch.py`. The training loop knows the
next view one step ahead, so a small worker pool decodes its `<image>_s.npy` /
`<image>_f.npy` maps and copies them to the device while the current step computes, and
a byte-bounded LRU keeps recently used views resident on the device.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor

import torch


def _nbytes(value) -> int:
    items = value if isinstance(value, (tuple, list)) else (value,)
    return sum(t.numel() * t.element_size() for t in items if isinstance(t, torch.Tensor))


class DeviceLRU:
    """Byte-bounded LRU of device tensors (thread-safe)."""

    def __init__(self, max_bytes: int = 2 << 30):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._items: OrderedDict = OrderedDict()
        self._bytes = 0

    def get(self, key):
        with self._lock:
            if key not in self._items:
                return None
            self._items.move_to_end(key)
            return self._items[key]

    def put(self, key, value) -> None:
        size = _nbytes(value)
        with self._lock:
            if key in self._items:
                self._items.move_to_end(key)
                return
            if size > self.max_bytes:
                return  # too big to ever cache
            while self._bytes + size > self.max_bytes and self._items:
                _, old = self._items.popitem(last=False)
                self._bytes -= _nbytes(old)
            self._items[key] = value
            self._bytes += size

    def __len__(self) -> int:
        return len(self._items)


class FeaturePrefetcher:
    """Overlaps feature-map decoding and the copy to the device with the train step.

    `schedule(cam)` starts a background load for a camera that will be used soon;
    `get(cam)` returns (feature [F, H, W], mask [1, H, W]) as tensors on `device`: from
    the LRU, from a pending load, or loaded now. Keys are camera image names.
    """

    def __init__(self, lf_path: str, feature_level: int, *, device: torch.device,
                 max_cache_bytes: int = 2 << 30, workers: int = 2):
        self.lf_path = lf_path
        self.feature_level = feature_level
        self.device = device
        self.cache = DeviceLRU(max_cache_bytes)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._lock = threading.Lock()
        self._pending: dict = {}

    def _load(self, cam):
        feat, mask = cam.get_language_feature(self.lf_path, self.feature_level)
        value = (torch.as_tensor(feat).to(self.device), torch.as_tensor(mask).to(self.device))
        self.cache.put(cam.image_name, value)
        return value

    def schedule(self, cam) -> None:
        key = cam.image_name
        if self.cache.get(key) is not None:
            return
        with self._lock:
            if key in self._pending:
                return
            fut = self._pool.submit(self._load, cam)
            self._pending[key] = fut

        def _done(_fut, key=key):
            with self._lock:
                self._pending.pop(key, None)

        # outside the lock: a load that has already finished runs `_done` right here,
        # in this thread, and `_done` takes the lock
        fut.add_done_callback(_done)

    def get(self, cam):
        key = cam.image_name
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        with self._lock:
            fut: Future | None = self._pending.get(key)
        if fut is not None:
            return fut.result()
        return self._load(cam)

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
