"""Host-device syncs a traced view of `embed_masks`: the increments of the program's
counter `host_syncs` (langsplat_tpu_torch/utils/tracing.py) over the traced views, over
their number."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "embed", "embed_masks", lambda s: s.count("host_syncs"))
