"""CUDA kernels the device ran a traced training step."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    r = ctx["reading"]
    if not r["kernels"]:
        return None
    return r["kernels"] / r["calls"]
