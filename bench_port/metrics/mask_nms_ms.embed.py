"""The mask NMS on the device (`masks_update`, inside the driver's span
`bench.mask_nms`: each level's masks stacked, their pairwise product and the keep
rules): device ms a traced view."""


def read(ctx):
    if ctx["kind"] != "embed":
        return None
    r = ctx["reading"]
    seconds, spans = r["spans"].get("mask_nms", (0.0, 0))
    if not spans or not seconds:
        return None
    return seconds / r["calls"] * 1e3
