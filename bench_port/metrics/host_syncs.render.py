"""Host–device syncs a traced view of render_full: the increments of the program's
counter `host_syncs` (langsplat_tpu_torch/utils/tracing.py) over the traced renders,
over their number."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "render", "render_full", lambda s: s.count("host_syncs"))
