"""Host ms a traced view inside the program's `sync.*` spans
(langsplat_tpu_torch/utils/tracing.py): how long render_full's host waited for the
card at its syncs. Host time is taken under the profiler, which slows the host about
1.5x: compare it across versions of the program, never against `render_ms_p95`."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "render", "render_full", lambda s: s.total_ms("sync."))
