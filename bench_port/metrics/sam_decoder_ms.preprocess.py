"""SAM's prompt encoder and mask decoder with the logits' post-processing on the device
(the predictor's `decode` and `upscale` and the generator's filters, inside the driver's
span `bench.sam_decoder`): device ms a traced view."""


def read(ctx):
    if ctx["kind"] != "preprocess":
        return None
    r = ctx["reading"]
    seconds, spans = r["spans"].get("sam_decoder", (0.0, 0))
    if not spans or not seconds:
        return None
    return seconds / r["calls"] * 1e3
