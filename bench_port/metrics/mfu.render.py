"""The traced renders' FP32 operations (counts.render_view, their blended pairs counted
by the reference) over the host-clock time of the same calls without the profiler,
as a % of the FP32 peak."""

from bench_port import counts


def read(ctx):
    if ctx["kind"] != "render":
        return None
    ops = sum(counts.render_view(w["capacity"], w["features"], w["instances"],
                                 w["blended"], w["width"], w["height"]).ops
              for w in ctx["work"])
    return 100.0 * ops / ctx["reading"]["untraced_s"] / counts.FP32_OPS_PER_S
