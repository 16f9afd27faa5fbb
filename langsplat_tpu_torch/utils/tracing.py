"""Spans and counters at the port's layer boundaries.

**Counters** are always on: `COUNTERS` is the one registry of plain integer counts,
incremented where the work happens.

- `host_syncs`: the host–device syncs the port's code makes (`host_read`, `upload`,
  `synced`, `select`), counted on any device: on a CUDA device each is one synchronize
  of the stream, so the host waits there for the card's queue to drain.
- `render_calls`, `render_attempts`: `train/loop.py render_full`'s calls and tries.
- `step_reruns`: training steps the loop discarded and ran again at grown caps.
- `launches.<kernel>`: the CUDA kernels' launches (`ops/_build.LAUNCHES` is a view).
- `feature_loads.<path>`: language-feature loads by path (`data/cameras.FEATURE_LOADS`).

**Spans** are on while a `torch.profiler` records (`torch.autograd._profiler_enabled()`),
and only then: the operator's `--profile_dir` window (`train/loop.py TraceWindow`) or a
benchmark's traced run. With tracing off, a span site is one call and that check; it
allocates and records nothing. A span records its name, its id, its parent's id, the id
of its root call (a root's own id, or the `call` it was given: the loop gives the
iteration number) and host start and end from `time.perf_counter_ns`. It is also opened
as `torch.profiler.record_function("langsplat.<name>")`, which puts it in the profiler's
trace, on the clock of the kernels it launches. Spans of one thread nest; a span opened
on another thread starts its own root.

A **session** is one period in which the profiler recorded: the first span after a
period with tracing off starts a new one and clears the last. The period is seen at the
first span site it reaches (or at `end_session()`, which `TraceWindow` calls as it
starts the profiler): two profiled periods with no site reached between them are one
session. `session()` returns its spans and the counter increments made during it (up
to the end of its last root span).
The spans are kept in memory only; their one export is the profiler's Chrome trace.

Sync spans are named `sync.<site>`. No name starts with `bench.`, the prefix of a
benchmark harness's own spans.
"""

from __future__ import annotations

import functools
import threading
import time
from collections.abc import MutableMapping

import torch
from torch.autograd import _profiler_enabled

#: the prefix of the spans' names in the profiler's trace
PREFIX = "langsplat."

#: the registry of counters, by name (see the module's docstring)
COUNTERS: dict[str, int] = {
    "host_syncs": 0, "render_calls": 0, "render_attempts": 0, "step_reruns": 0,
    "launches.blend_fwd": 0, "launches.blend_bwd": 0, "launches.segsum": 0,
    "feature_loads.native": 0, "feature_loads.numpy": 0}


class CounterView(MutableMapping):
    """The counters of COUNTERS whose names start with `prefix`, keyed by the rest of
    their names: reads and writes go to the registry."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def __getitem__(self, key: str) -> int:
        return COUNTERS[self.prefix + key]

    def __setitem__(self, key: str, value: int) -> None:
        COUNTERS[self.prefix + key] = value

    def __delitem__(self, key: str) -> None:
        raise TypeError("a counter cannot be removed")

    def __iter__(self):
        n = len(self.prefix)
        return iter([k[n:] for k in COUNTERS if k.startswith(self.prefix)])

    def __len__(self) -> int:
        return sum(1 for k in COUNTERS if k.startswith(self.prefix))

    def __repr__(self) -> str:
        return repr(dict(self))


class Span:
    """One span: times in ns of `time.perf_counter_ns`; `end_ns` None while open."""
    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns")

    def __init__(self, name, id, parent, root, start_ns, end_ns=None):
        self.name, self.id, self.parent, self.root = name, id, parent, root
        self.start_ns, self.end_ns = start_ns, end_ns

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class Session:
    """The spans of one profiled period, in the order they opened, and the counter
    increments made during it."""

    def __init__(self, spans: list[Span] | None = None, counts: dict | None = None):
        self.spans = [] if spans is None else spans
        self.counts = {} if counts is None else counts

    def roots(self) -> list[Span]:
        return [s for s in self.spans if s.parent is None]

    def of_calls(self, name: str, calls: int) -> bool:
        """Whether the session's root spans are `calls` spans named `name`, one or
        more."""
        roots = self.roots()
        return calls > 0 and len(roots) == calls and all(r.name == name for r in roots)

    def self_ns(self) -> dict[int, int]:
        """Each closed span's self time, by id: its duration less its children's (the
        children of one span do not overlap)."""
        own = {s.id: s.ns for s in self.spans if s.end_ns is not None}
        for s in self.spans:
            if s.parent in own and s.end_ns is not None:
                own[s.parent] -= s.ns
        return own

    def self_ms(self, *names: str) -> float:
        """The summed self time in ms of the spans named in `names`."""
        own = self.self_ns()
        return sum(own.get(s.id, 0) for s in self.spans if s.name in names) * 1e-6

    def total_ms(self, prefix: str) -> float:
        """The summed duration in ms of the closed spans whose names start with
        `prefix` (which must not nest in one another)."""
        return sum(s.ns for s in self.spans
                   if s.name.startswith(prefix) and s.end_ns is not None) * 1e-6

    def count(self, name: str) -> int:
        return self.counts.get(name, 0)


class _State(threading.local):
    """Per thread: the open spans, innermost last."""

    def __init__(self):
        self.stack: list[Span] = []


class _Recorder:
    """The current session's spans and counter snapshots, and whether tracing was off
    since its last span."""

    def __init__(self):
        self.idle = True
        self.spans: list[Span] = []
        self.first = dict(COUNTERS)
        self.last = dict(COUNTERS)
        self.next_id = 0
        self.lock = threading.Lock()

    def begin(self) -> None:
        with self.lock:
            self.spans = []
            self.first = dict(COUNTERS)
            self.last = dict(self.first)
            self.next_id = 0
            self.idle = False


_local = _State()
_rec = _Recorder()


class _Off:
    """The span of a site with tracing off: enters and exits doing nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """An open span while tracing is on."""
    __slots__ = ("name", "call", "span", "rf")

    def __init__(self, name: str, call: int | None):
        self.name, self.call = name, call

    def __enter__(self):
        if _rec.idle:
            _rec.begin()
            _local.stack = []
        stack = _local.stack
        self.rf = torch.profiler.record_function(PREFIX + self.name)
        self.rf.__enter__()
        with _rec.lock:
            sid = _rec.next_id
            _rec.next_id += 1
        if stack:
            parent = stack[-1]
            span = Span(self.name, sid, parent.id, parent.root, 0)
        else:
            span = Span(self.name, sid, None, sid if self.call is None else self.call, 0)
        _rec.spans.append(span)
        stack.append(span)
        self.span = span
        span.start_ns = time.perf_counter_ns()
        return span

    def __exit__(self, *exc):
        span = self.span
        span.end_ns = time.perf_counter_ns()
        stack = _local.stack
        if stack and stack[-1] is span:
            stack.pop()
        if span.parent is None:
            _rec.last = dict(COUNTERS)
        self.rf.__exit__(*exc)
        return False


def span(name: str, call: int | None = None):
    """A context manager: the span `name` while tracing is on, else nothing. `call`
    is the id its spans share when it opens as a root (else the root's own id)."""
    if not _profiler_enabled():
        _rec.idle = True
        return _OFF
    return _On(name, call)


def traced(name: str):
    """Decorator: each call of the function inside the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not _profiler_enabled():
                _rec.idle = True
                return fn(*args, **kw)
            with _On(name, None):
                return fn(*args, **kw)
        return call
    return wrap


def synced(name: str, syncs: int = 1):
    """A context manager around code that syncs `syncs` times (a data-dependent size,
    such as `nonzero`'s): counted in `host_syncs`, and the span `sync.<name>`."""
    COUNTERS["host_syncs"] += syncs
    if not _profiler_enabled():
        _rec.idle = True
        return _OFF
    return _On("sync." + name, None)


def host_read(name: str, tensor: torch.Tensor):
    """The one element of a device tensor as a Python number (`tensor.item()`, as
    `int`, `float` or `bool` give it): one counted sync, in the span `sync.<name>`."""
    with synced(name):
        return tensor.item()


def upload(name: str, data, *, dtype: torch.dtype | None = None,
           device: str | torch.device | None = None) -> torch.Tensor:
    """`torch.tensor(data, dtype=dtype, device=device)`: host data copied to the device,
    one counted sync (a copy from pageable memory waits for the stream), in the span
    `sync.<name>`."""
    with synced(name):
        return torch.tensor(data, dtype=dtype, device=device)


def select(name: str, tensor: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`tensor[mask]` of a boolean mask, whose size the host reads: one counted sync,
    in the span `sync.<name>`."""
    with synced(name):
        return tensor[mask]


def end_session() -> None:
    """End the current session: the next span recorded starts a new one."""
    _rec.idle = True


def session() -> Session:
    """The last session's spans (open ones have `end_ns` None) and the counter
    increments made from its start to the end of its last root span."""
    with _rec.lock:
        spans = list(_rec.spans)
        counts = {k: v - _rec.first.get(k, 0) for k, v in _rec.last.items()}
    return Session(spans, counts)
