"""Run one cell of the benchmark of `langsplat_tpu_torch` once, on the CUDA card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of `workloads` in BENCHMARK.json.
Set-up makes the inputs from the seed, builds the program's state, runs the calls the
comparison follows and warms up; then, with --trace 0, a window of --seconds measures
the cell's end-to-end metrics, and with --trace 1 a torch.profiler window over a fixed
number of calls gives its per-layer metrics. Once the window has closed, the device's
memory peak is read, the program's state is freed and the plain reference
(`bench_port/reference/`) decides `correct`. The last line of standard output is the
result as one JSON object; each number compared is printed beside its limit as the
last lines of standard error and, under "checks", last in the result.

Exits with 2, printing no result, when there is no CUDA card or fewer than the cell
asks for, and with 3 when JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of `cell` on `device`; returns the result (without printing it)."""
    import torch

    from bench_port import harness

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    r = harness.driver(cell).Run(cell, seed, device)
    setup_s = time.perf_counter() - t_start
    extra = {}
    if trace:
        ctx = r.traced()
        attempted, failed, reruns = ctx["attempted"], 0, ctx.get("reruns")
    else:
        window = r.window(seconds)
        attempted, failed, reruns = window["attempted"], window["failed"], window.get(
            "reruns")
    if reruns is not None:
        print(f"run.py: {reruns} calls re-run at grown caps in the window",
              file=sys.stderr)
    info = harness.device_info(device)
    metrics = {}
    if trace:
        reading = ctx["reading"]
        extra = {"busy_s": reading["busy_s"], "window_s": reading["window_s"]}
        r.work(ctx)
        for m in cell.per_layer:
            value = harness.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        for name, value in window["metrics"].items():
            if name in units:
                metrics[name] = {"value": value, "unit": units[name]}
        metrics["setup_s"] = {"value": setup_s, "unit": units["setup_s"]}
    r.release()
    t_check = time.perf_counter()
    numbers = r.check()
    print(f"run.py: the comparison took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    correct, checks = harness.judge(numbers, cell.limits)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": dict(info, **extra)}
    if trace:
        result["breakdown"] = reading["breakdown"]
    if reruns is not None:
        result["reruns"] = reruns
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from bench_port import harness

    cell = harness.load_cell(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              f"available", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                 T_START)
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"run.py: modules of JAX or the JAX package were loaded: {forbidden}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
