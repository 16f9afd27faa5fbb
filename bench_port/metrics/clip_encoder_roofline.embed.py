"""CLIP's image tower (the encoder `embed_masks` calls, inside the driver's span
`bench.clip_encoder`) over the traced views: its least time on the card
(counts_clip.encoder of each level's tiles, 64 a pass: FP32 operations over 67 TFLOP/s
or bytes over 3.35 TB/s, the larger) over its device time in the trace, in %."""

from bench_port import counts_clip


def read(ctx):
    if ctx["kind"] != "embed":
        return None
    seconds, spans = ctx["reading"]["spans"].get("clip_encoder", (0.0, 0))
    if not spans or not seconds:
        return None
    bound = sum(counts_clip.encoder(w["config"], w["tiles"]).bound_s() for w in ctx["work"])
    return 100.0 * bound / seconds
