"""Self host ms a traced training step of the forward render: the program's spans
`render`, `preprocess`, `binning` and `blend`, each less its children (so less its
syncs). Host time is taken under the profiler, which slows the host about 1.5x:
compare it across versions of the program, never against `train_step_ms`."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "train", "train_step",
                    lambda s: s.self_ms("render", "preprocess", "binning", "blend"))
