"""The device's idle share of the traced views, in %: 1 - the device's busy time under
the profiler over the host-clock time of the same calls without it."""


def read(ctx):
    if ctx["kind"] != "embed":
        return None
    r = ctx["reading"]
    if not r["busy_s"]:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["untraced_s"])
