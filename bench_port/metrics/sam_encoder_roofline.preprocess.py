"""SAM's image encoder (the predictor's `set_image`, inside the driver's span
`bench.sam_encoder`) over the traced views: its least time on the card (counts_sam.encoder
of each crop: FP32 operations over 67 TFLOP/s or bytes over 3.35 TB/s, the larger) over
its device time in the trace, in %."""

from bench_port import counts_sam


def read(ctx):
    if ctx["kind"] != "preprocess":
        return None
    seconds, crops = ctx["reading"]["spans"].get("sam_encoder", (0.0, 0))
    if not crops or not seconds:
        return None
    bound = counts_sam.encoder(ctx["work"][0]["config"]).bound_s() * crops
    return 100.0 * bound / seconds
