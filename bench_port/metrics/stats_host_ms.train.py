"""Self host ms a traced phase-A training step of the densification statistics: the
program's span `stats` (train/trainer.py: `update_stats` and the PSNR), less its
children (its sync). None where no step has the span (phase B). Host time is taken
under the profiler, which slows the host about 1.5x: compare it across versions of the
program, never against `train_step_ms`."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "train", "train_step", lambda s: s.self_ms("stats") if any(
        span.name == "stats" for span in s.spans) else None)
