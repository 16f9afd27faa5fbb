"""Run logging: timestamped stdout, optional TensorBoard scalars (tensorboardX), an EMA
of the loss, and a step timer.

PyTorch counterpart of `langsplat_tpu/utils/logging.py`.
"""

from __future__ import annotations

import time
from datetime import datetime

import torch


class RunLogger:
    def __init__(self, log_dir: str | None = None, quiet: bool = False,
                 ema_decay: float = 0.6):
        self.quiet = quiet
        self.ema_decay = ema_decay
        self.ema_loss: float | None = None
        self.writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
                self.writer = SummaryWriter(log_dir)
            except Exception:
                self.log("tensorboardX unavailable: not logging progress")

    def log(self, msg: str) -> None:
        if not self.quiet:
            stamp = datetime.now().strftime("%d/%m %H:%M:%S")
            print(f"{msg} [{stamp}]", flush=True)

    def scalar(self, tag: str, value, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def progress(self, iteration: int, loss: float, every: int = 10,
                 extra: str = "") -> None:
        self.ema_loss = (loss if self.ema_loss is None
                         else (1 - self.ema_decay) * loss
                         + self.ema_decay * self.ema_loss)
        if iteration % every == 0:
            self.log(f"iter {iteration}: ema_loss={self.ema_loss:.7f}{extra}")

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


class Timer:
    """Wall time of a step in ms, ending in a synchronize of the card the step ran on
    (on the CPU there is nothing to wait for)."""

    def __init__(self, device: torch.device | None = None):
        self.device = device
        self.t0 = None
        self.elapsed_ms = 0.0

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed_ms = (time.perf_counter() - self.t0) * 1e3
        return self.elapsed_ms
