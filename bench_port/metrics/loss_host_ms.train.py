"""Self host ms a traced training step of the losses: the program's span `loss`
(train/trainer.py; SSIM and L1, or the masked feature L1), less its children. Host
time is taken under the profiler, which slows the host about 1.5x: compare it across
versions of the program, never against `train_step_ms`."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "train", "train_step", lambda s: s.self_ms("loss"))
