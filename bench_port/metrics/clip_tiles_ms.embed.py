"""The CLIP tiles and seg maps on the device (`mask_to_segmap` a level, inside the
driver's span `bench.clip_tiles`): device ms a traced view."""


def read(ctx):
    if ctx["kind"] != "embed":
        return None
    r = ctx["reading"]
    seconds, spans = r["spans"].get("clip_tiles", (0.0, 0))
    if not spans or not seconds:
        return None
    return seconds / r["calls"] * 1e3
