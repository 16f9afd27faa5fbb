"""Host ms a traced training step inside the program's `sync.*` spans
(langsplat_tpu_torch/utils/tracing.py): how long the host waited for the card at its
syncs. Host time is taken under the profiler, which slows the host about 1.5x: compare
it across versions of the program, never against `train_step_ms`."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "train", "train_step", lambda s: s.total_ms("sync."))
