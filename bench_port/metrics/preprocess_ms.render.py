"""ops/projection.py preprocess: device ms a traced view of the kernels launched inside
its span `bench.preprocess`, read from the trace of the timed calls."""


def read(ctx):
    if ctx["kind"] != "render":
        return None
    r = ctx["reading"]
    seconds, spans = r["spans"].get("preprocess", (0.0, 0))
    if not spans or not seconds:
        return None
    return seconds / r["calls"] * 1e3
