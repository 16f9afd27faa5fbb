"""Host–device syncs a traced training step: the increments of the program's counter
`host_syncs` (langsplat_tpu_torch/utils/tracing.py) over the traced steps, over their
number. Each drains the card's queue, so the launches after it find the card idle."""

from bench_port.program_session import per_call


def read(ctx):
    return per_call(ctx, "train", "train_step", lambda s: s.count("host_syncs"))
