"""A torch.profiler window over a fixed number of calls, read back from its Chrome trace:
the device's busy time (the union of its operations' intervals), each device
operation's time and count, the CUDA kernels launched, the device time of the work
launched inside each of the harness's spans (`spanned`), and the idle gaps of the
device named by what the host was doing: the innermost host operation that launched
the work ending the gap. Beside it, `untraced_seconds` times the same calls without the
profiler, which slows the host.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"
#: the prefix of the harness's spans around parts of the timed path (`spanned`)
SPAN = "bench."
#: the least host-clock time over which `untraced_seconds` times the calls
LEAST_S = 1.0


def spanned(name: str, fn):
    """`fn` called inside the profiler span SPAN + name."""
    from torch.profiler import record_function

    def call(*args, **kw):
        with record_function(SPAN + name):
            return fn(*args, **kw)
    return call


def untraced_seconds(fn, calls: int, device, reset) -> float:
    """Host-clock seconds of `fn(i)` for i in range(calls), without the profiler, each
    repetition after `reset()` and ending in a synchronize: the mean over as many
    repetitions as span LEAST_S or more."""
    total, reps = 0.0, 0
    while total < LEAST_S:
        reset()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        total += time.perf_counter() - t0
        reps += 1
    return total / reps


def profile(fn, calls: int, device) -> dict:
    """Run `fn(i)` for i in range(calls) under the profiler; the window ends with a
    synchronize. Returns the reading of the trace and the window's host-clock seconds."""
    from torch.profiler import ProfilerActivity, record_function
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for i in range(calls):
                fn(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return dict(read(events), window_s=window_s, calls=calls)


def _innermost(spans: list, queries: list) -> list:
    """For each query time (ascending), the name of the innermost host span that
    contains it (None if none does), the latest-starting one over the host threads.
    `spans` are (start, end, name, thread) sorted by start; spans of one thread nest."""
    stacks: dict = {}
    out, i = [], 0
    for t in queries:
        while i < len(spans) and spans[i][0] <= t:
            s, e, name, tid = spans[i]
            stack = stacks.setdefault(tid, [])
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, e, name))
            i += 1
        best = None
        for stack in stacks.values():
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack and (best is None or stack[-1][0] > best[0]):
                best = stack[-1]
        out.append(None if best is None else best[2])
    return out


def read(events: list) -> dict:
    complete = [e for e in events if e.get("ph") == "X"]
    window = [e for e in complete if e.get("name") == WINDOW]
    lo, hi = (window[0]["ts"], window[0]["ts"] + window[0]["dur"]) if window else (
        -float("inf"), float("inf"))
    device = sorted((e for e in complete if e.get("cat") in DEVICE_CATS
                     and lo <= e["ts"] <= hi), key=lambda e: e["ts"])
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid")) for e in complete
                   if e.get("cat") in HOST_CATS and e.get("name") != WINDOW),
                  key=lambda span: span[0])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in complete
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    marks = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in complete
                   if e.get("cat") == "user_annotation" and e["name"] != WINDOW
                   and e["name"].startswith(SPAN))
    starts = [m[0] for m in marks]
    spans: dict[str, list] = {}
    for _, _, name in marks:
        spans.setdefault(name[len(SPAN):], [0.0, 0])[1] += 1

    ops: dict[str, list] = {}
    for e in device:
        acc = ops.setdefault(e["name"][:100], [0.0, 0])
        acc[0] += e["dur"] * 1e-6
        acc[1] += 1
        launched = launch_ts.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, launched) - 1 if launched is not None else -1
        if i >= 0 and launched <= marks[i][1]:
            spans[marks[i][2][len(SPAN):]][0] += e["dur"] * 1e-6
    busy_us, end, idle = 0.0, None, []
    for e in device:
        start, stop = e["ts"], e["ts"] + e["dur"]
        if end is not None and start > end:
            launched = launch_ts.get(e.get("args", {}).get("correlation"), start)
            idle.append((launched, (start - end) * 1e-6))
        if end is None or stop > end:
            busy_us += stop - max(start, end if end is not None else start)
            end = stop
    idle.sort(key=lambda g: g[0])
    gaps: dict[str, float] = {}
    for (_, seconds), name in zip(idle, _innermost(host, [t for t, _ in idle])):
        name = name or "host outside any operation"
        gaps[name] = gaps.get(name, 0.0) + seconds
    return dict(
        busy_s=busy_us * 1e-6,
        device_ops=ops,
        kernels=sum(1 for e in device if e.get("cat") == "kernel"),
        spans=spans,
        breakdown=dict(
            device_ops=[[n, v[0]] for n, v in sorted(ops.items(),
                                                     key=lambda kv: -kv[1][0])[:10]],
            idle_gaps=[[n, s] for n, s in sorted(gaps.items(),
                                                 key=lambda kv: -kv[1])[:10]]))


def kernel_seconds(reading: dict, symbol: str) -> tuple[float, int]:
    """(device seconds, launches) of the device operations whose name holds `symbol`."""
    total, count = 0.0, 0
    for name, (seconds, n) in reading["device_ops"].items():
        if symbol in name:
            total += seconds
            count += n
    return total, count
