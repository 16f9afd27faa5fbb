"""The traced views' FP32 operations (counts_sam.view: every crop's encoder pass and
every prompt's decode) over the host-clock time of the same calls without the profiler,
as a % of the FP32 peak."""

from bench_port import counts_sam


def read(ctx):
    if ctx["kind"] != "preprocess":
        return None
    ops = sum(counts_sam.view(w["config"], w["crops"], w["prompts"]).ops
              for w in ctx["work"])
    return 100.0 * ops / ctx["reading"]["untraced_s"] / counts_sam.FP32_OPS_PER_S
