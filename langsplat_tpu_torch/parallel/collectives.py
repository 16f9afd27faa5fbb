"""The collectives of the multi-device training, and the one place that knows the
process group's backend.

The JAX package's `shard_map` bodies call `jax.lax` collectives over a mesh axis; here
each rank is a process and an axis is a `torch.distributed` process group (`mesh.py`):

  - `mean`, `sum_`, `max_`: all-reduce (JAX `pmean`, `psum`, `pmax`); `mean` is the sum
    divided by the group's size, as `pmean` is;
  - `reduce_scatter_rows`: the sum over the group, each rank keeping its contiguous
    1/n of the rows (`psum_scatter(..., scatter_dimension=0, tiled=True)`);
  - `all_gather_rows`: the ranks' row blocks concatenated in rank order
    (`all_gather(..., axis=0, tiled=True)`), differentiable: its backward is
    `reduce_scatter_rows` of the gradient, the VJP the Gaussian-sharded and
    depth-sharded steps rely on;
  - `gather_object`: every rank's picklable value, in rank order (results, hashes).

`group=None` means the default (world) group. Without an initialised process group every
collective is the identity on the caller's values, so the same step runs in one process;
a group of one still calls the backend.

Backends: NCCL on cards when every rank has its own card; gloo on the CPU, and on cards
when ranks share one (`launch.py` picks, `--dist_backend` overrides; nothing here
switches). Gloo on torch 2.11 takes CUDA tensors in every collective used here
(all_reduce sum and max in float32 and int64, all_gather_into_tensor,
reduce_scatter_tensor, all_gather_object, barrier; `runner.collectives_check` holds each
against the CPU result), copying them through host memory itself, so no collective is
staged here. Every collective's time is recorded (CUDA events on a card, the host clock
on the CPU) and read with `timings()`.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

_pending: list = []      # (name, start, end): CUDA events, or host-clock floats
_totals: dict = {}       # name -> {"calls", "ms"} of the folded entries
#: pending entries past which they are folded into the totals (a synchronize on a card)
_FOLD_AT = 256


def active() -> bool:
    """Whether there is a process group to talk to (a group of one included, so that a
    1-rank NCCL or gloo group runs its collectives too)."""
    return dist.is_available() and dist.is_initialized()


def size(group=None) -> int:
    return dist.get_world_size(group) if active() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if active() else 0


def backend(group=None) -> str | None:
    return dist.get_backend(group) if dist.is_available() and dist.is_initialized() \
        else None


class _Clock:
    """Records the time of the collective it wraps."""

    def __init__(self, name: str, t: torch.Tensor):
        self.name, self.cuda = name, t.is_cuda

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.start = time.perf_counter()

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        else:
            end = time.perf_counter()
        _pending.append((self.name, self.start, end))
        if len(_pending) > _FOLD_AT:
            _fold()


def _fold() -> None:
    if any(not isinstance(s, float) for _, s, _ in _pending):
        torch.cuda.synchronize()
    for name, start, end in _pending:
        ms = (end - start) * 1e3 if isinstance(start, float) else start.elapsed_time(end)
        rec = _totals.setdefault(name, {"calls": 0, "ms": 0.0})
        rec["calls"] += 1
        rec["ms"] += ms
    _pending.clear()


def _all_reduce(t: torch.Tensor, op, name: str, group) -> torch.Tensor:
    if not active():
        return t
    out = t.detach().clone().contiguous()
    with _Clock(name, out):
        dist.all_reduce(out, op=op, group=group)
    return out


def sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's sum of `t` (`psum`); a new tensor, no gradient."""
    return _all_reduce(t, dist.ReduceOp.SUM, "sum", group)


def mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's sum of `t` divided by its size (`pmean`)."""
    return sum_(t, group) / size(group) if active() else t.detach()


def max_(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's elementwise maximum of `t` (`pmax`)."""
    return _all_reduce(t, dist.ReduceOp.MAX, "max", group)


def reduce_scatter_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's sum of `t` [R, ...], rank r keeping rows [r R/n, (r+1) R/n)."""
    if not active():
        return t
    n = size(group)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not divide over {n} ranks")
    src = t.contiguous()
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    with _Clock("reduce_scatter_rows", out):
        dist.reduce_scatter_tensor(out, src, group=group)
    return out


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    n = size(group)
    src = t.contiguous()
    out = torch.empty((t.shape[0] * n,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    with _Clock("all_gather_rows", out):
        dist.all_gather_into_tensor(out, src, group=group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _gather_rows(t, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` [R, ...] concatenated in rank order [n R, ...]; differentiable,
    its backward the reduce-scatter (the sum over ranks of each rank's rows' gradient)."""
    if not active():
        return t
    if t.requires_grad:
        return _AllGatherRows.apply(t, group)
    return _gather_rows(t, group)


def gather_object(obj, group=None) -> list:
    """Every rank's picklable `obj`, in rank order."""
    if not active():
        return [obj]
    out = [None] * size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def barrier(group=None) -> None:
    if active():
        dist.barrier(group=group)


def reset() -> None:
    """Forget the recorded times."""
    _pending.clear()
    _totals.clear()


def timings() -> dict:
    """{name: {"calls", "ms"}} of the collectives since `reset`: CUDA events on a card
    (synchronised here), the host clock on the CPU."""
    _fold()
    return {name: dict(rec) for name, rec in _totals.items()}
