"""render_full's tries a call over the traced renders: the program's counters
`render_attempts` over `render_calls` (train/loop.py; 1.0 when no call retries at a
grown instance budget or tile cap)."""

from bench_port.program_session import session_of


def read(ctx):
    s = session_of(ctx, "render", "render_full")
    if s is None or not s.count("render_calls"):
        return None
    return s.count("render_attempts") / s.count("render_calls")
