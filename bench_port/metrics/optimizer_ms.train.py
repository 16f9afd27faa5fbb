"""Adam's update (train/trainer.py Adam.update): device ms a traced step of the kernels
launched inside its span `bench.optimizer`, read from the trace of the timed calls."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    r = ctx["reading"]
    seconds, spans = r["spans"].get("optimizer", (0.0, 0))
    if not spans or not seconds:
        return None
    return seconds / r["calls"] * 1e3
