"""K1 (csrc/blend_fwd.cu) over the traced training steps: its least time on the card
(counts.k1 of each step's work) over its device time in the trace, in %."""

from bench_port import counts, trace


def read(ctx):
    if ctx["kind"] != "train":
        return None
    seconds, launches = trace.kernel_seconds(ctx["reading"], "blend_fwd_kernel")
    if not launches:
        return None
    bound = sum(counts.k1(w["capacity"], w["features"] if w["phase"] == "B" else 0,
                          w["instances"], w["blended"], w["width"],
                          w["height"]).bound_s() for w in ctx["work"])
    return 100.0 * bound / seconds
