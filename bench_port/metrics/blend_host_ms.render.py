"""Self host ms a traced view of the forward blend: the program's span `blend`
(ops/render.py, around K1's launch and its wrapper), less its children. Host time is
taken under the profiler, which slows the host about 1.5x: compare it across versions
of the program, never against `render_views_per_s`."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "render", "render_full", lambda s: s.self_ms("blend"))
