"""Where a traced call's device idle time goes, by the port's layer.

    python3 scripts/trace_layers.py --cell train-a.synthroom-15k [--seed 7]
        [--out layer_traces]

On the CUDA card, from the root of a checkout. Sets up one cell of BENCHMARK.json as
its benchmark does (`bench_port/drivers/`), runs 3 calls without the profiler, then 3
under torch.profiler (CPU and CUDA activity), writes the Chrome trace to
`<out>/<cell>.trace.json` and prints one JSON line. A device idle gap is put down to the
innermost `langsplat.*` span (`langsplat_tpu_torch/utils/tracing.py`) that holds the
host's launch of the work ending the gap, as a path from the root span
(`train_step/render/binning`; OUTSIDE where the launch is in no span). For each path, a
call: `idle_ms`, the gaps' ms; `device_ms` and `launches`, the work launched inside it;
`self_ms`, its host self time from the tracer's session (all host times under the
profiler, which slows the host). Beside them: the window's host ms, the device's busy
ms and idle share, and the counters' increments a call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import trace  # noqa: E402
from langsplat_tpu_torch.utils import tracing  # noqa: E402

#: calls traced, after as many untraced to warm up
CALLS = WARM = 3
#: where a gap's work was launched in no span, as bench_port/trace.py names it
OUTSIDE = "host outside any operation"


def span_paths(spans: list[tuple]) -> list[str]:
    """For spans (start, end, name, ...) of one thread, sorted by start, each one's path
    of names from its outermost enclosing span."""
    paths, stack = [], []
    for start, end, name, *_ in spans:
        while stack and stack[-1][1] < start:
            stack.pop()
        path = f"{stack[-1][2]}/{name}" if stack else name
        stack.append((start, end, path))
        paths.append(path)
    return paths


def read(events: list[dict], calls: int) -> dict:
    """The trace's idle gaps, device time and launches by innermost span path, a call.
    The busy time and the gaps are bench_port/trace.py's reading of the trace with the
    program's spans, named by path, as its only host spans (its ten largest gaps)."""
    complete = [e for e in events if e.get("ph") == "X"]
    (window,) = [e for e in complete
                 if e["name"] == trace.WINDOW and e.get("cat") == "user_annotation"]
    prefix = tracing.PREFIX
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(prefix):], e.get("tid"))
                   for e in complete if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix) and e.get("tid") == window.get("tid"))
    spans = [(s, e, path, tid) for (s, e, _, tid), path in zip(spans, span_paths(spans))]
    harness = trace.read(
        [e for e in complete
         if e.get("cat") not in trace.HOST_CATS and e["name"] != trace.WINDOW] + [window]
        + [dict(ph="X", cat="user_annotation", name=path, ts=s, dur=e - s, tid=tid)
           for s, e, path, tid in spans])

    lo, hi = window["ts"], window["ts"] + window["dur"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in complete
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    launched = sorted((launch_ts[e["args"]["correlation"]], e["dur"]) for e in complete
                      if e.get("cat") in trace.DEVICE_CATS and lo <= e["ts"] <= hi
                      and e.get("args", {}).get("correlation") in launch_ts)
    by: dict[str, dict] = {}

    def entry(path):
        return by.setdefault(path or OUTSIDE, dict(idle_ms=0.0, device_ms=0.0, launches=0))

    for (_, dur), path in zip(launched, trace._innermost(spans, [t for t, _ in launched])):
        entry(path)["device_ms"] += dur * 1e-3 / calls
        entry(path)["launches"] += 1 / calls
    for path, seconds in harness["breakdown"]["idle_gaps"]:
        entry(path)["idle_ms"] += seconds * 1e3 / calls
    window_ms = window["dur"] * 1e-3
    return dict(window_ms=window_ms / calls, busy_ms=harness["busy_s"] * 1e3 / calls,
                idle_share=1.0 - harness["busy_s"] * 1e3 / window_ms, by_span=by)


def session_self_ms(session, calls: int) -> dict:
    """Each span path's self host ms a call, from the tracer's session."""
    by_id = {s.id: s for s in session.spans}
    own = session.self_ns()
    out: dict[str, float] = {}
    for s in session.spans:
        names, p = [s.name], s
        while p.parent is not None:
            p = by_id[p.parent]
            names.append(p.name)
        path = "/".join(reversed(names))
        out[path] = out.get(path, 0.0) + own.get(s.id, 0) * 1e-6 / calls
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cell", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", default="layer_traces")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_layers.py: needs a CUDA card", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile, record_function

    from bench_port import harness

    device = torch.device("cuda")
    cell = harness.load_cell(args.cell)
    t0 = time.perf_counter()
    run = harness.driver(cell).Run(cell, args.seed, device)
    setup_s = time.perf_counter() - t0
    if cell.mix["kind"] == "train":
        call = lambda i: run.next_step()   # noqa: E731
    else:
        call = run._call
    for i in range(WARM):
        call(i)
    torch.cuda.synchronize(device)
    before = dict(tracing.COUNTERS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for i in range(CALLS):
                call(WARM + i)
            torch.cuda.synchronize(device)
    moved = {k: (v - before[k]) / CALLS for k, v in tracing.COUNTERS.items()
             if v != before[k]}
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.cell}.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        reading = read(json.load(f)["traceEvents"], CALLS)
    self_ms = session_self_ms(tracing.session(), CALLS)
    for span_path, ms in self_ms.items():
        reading["by_span"].setdefault(span_path, dict(idle_ms=0.0, device_ms=0.0,
                                                      launches=0))["self_ms"] = ms
    reading["by_span"] = dict(sorted(reading["by_span"].items(),
                                     key=lambda kv: -kv[1]["idle_ms"]))
    print(json.dumps(dict(cell=args.cell, seed=args.seed, calls=CALLS,
                          setup_s=setup_s, device=torch.cuda.get_device_name(device),
                          counters=moved, trace=path, **reading)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
