"""Self host ms a traced view of binning: the program's span `binning` (ops/render.py,
around `tiles.bin_gaussians`), less its children, its `sync.binning.*` spans. Host
time is taken under the profiler, which slows the host about 1.5x: compare it across
versions of the program, never against `render_views_per_s`."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "render", "render_full", lambda s: s.self_ms("binning"))
