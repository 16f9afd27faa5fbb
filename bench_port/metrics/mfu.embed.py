"""The traced views' FP32 operations (counts_clip.view: each level's mask-NMS product
and every tile through the tower) over the host-clock time of the same calls without
the profiler, as a % of the FP32 peak."""

from bench_port import counts_clip


def read(ctx):
    if ctx["kind"] != "embed":
        return None
    ops = sum(counts_clip.view(w["config"], w["masks"], w["tiles"], w["pixels"]).ops
              for w in ctx["work"])
    return 100.0 * ops / ctx["reading"]["untraced_s"] / counts_clip.FP32_OPS_PER_S
