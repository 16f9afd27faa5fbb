"""Self host ms a traced training step of Adam: the program's span `optimizer` (around
`Adam.update` in train/trainer.py), less its children. Beside `optimizer_ms.train`,
the device time of the same update, it says whether Adam is paced by the host or by
the card. Host time is taken under the profiler, which slows the host about 1.5x:
compare it across versions of the program, never against `train_step_ms`."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "train", "train_step", lambda s: s.self_ms("optimizer"))
