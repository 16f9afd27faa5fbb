"""Self host ms a traced training step of the autograd backward: the program's span
`backward` (train/trainer.py, the `torch.autograd.grad` call that launches K2, K3 and
the PyTorch backward), less its children. Host time is taken under the profiler, which
slows the host about 1.5x: compare it across versions of the program, never against
`train_step_ms`."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "train", "train_step", lambda s: s.self_ms("backward"))
