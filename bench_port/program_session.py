"""The program's own tracer session, for the per-layer readers of its spans and counters.

`langsplat_tpu_torch/utils/tracing.py` records spans while a torch.profiler records,
so in a `--trace 1` run its session is exactly the traced calls. A program without the
tracer reads nothing. Host times in it are taken under the profiler, which slows the
host about 1.5x: compare them across versions of the program, never against an
end-to-end metric.
"""

from __future__ import annotations


def session_of(ctx, kind: str, root: str):
    """The tracer's session of the traced calls, or None: the cell is of another kind
    than `kind`, the program has no tracer, or the session's root spans are not
    `ctx["reading"]["calls"]` spans named `root`."""
    if ctx["kind"] != kind:
        return None
    try:
        from langsplat_tpu_torch.utils.tracing import session
    except ImportError:
        return None
    s = session()
    return s if s.of_calls(root, ctx["reading"]["calls"]) else None


def per_call(ctx, kind: str, root: str, value):
    """`value(session)` over the number of traced calls; None where `session_of` is,
    or where `value` gives None."""
    s = session_of(ctx, kind, root)
    v = None if s is None else value(s)
    return None if v is None else v / ctx["reading"]["calls"]
