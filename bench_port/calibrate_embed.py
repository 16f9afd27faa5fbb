"""The readings the limits of embed.clip-vit-b16 come from, on the card.

    python3 bench_port/calibrate_embed.py --seeds 1,2,... [--control-seeds 1,2,3] \
        [--seconds 8] [--workload embed.clip-vit-b16]

For each seed, one set-up of the cell as a benchmark run makes it, a short window (the
checked views come from it) and the numbers that decide `correct`: the program against
the reference (the lower reading, over a dozen seeds or more). For each control seed
also the control (the reference in bfloat16 in the program's place), the reference with
TF32 allowed for its matrix products (a precision below the configuration's float32),
and the fault "QuickGELU in place of the exact GELU" (the upper readings). One JSON line
a seed, with the masks the views held and kept and the tiles encoded; benchmark runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, device, seconds: float, control: bool) -> dict:
    import torch

    from bench_port import harness
    from bench_port.reference import Precision
    from langsplat_tpu_torch.utils.tracing import COUNTERS

    t0 = time.perf_counter()
    r = harness.driver(cell).Run(cell, seed, device)
    before = {k: COUNTERS[k] for k in ("mask_nms.masks", "mask_nms.kept", "clip.tiles")}
    window = r.window(seconds)
    moved = {k: (COUNTERS[k] - v) / window["attempted"] for k, v in before.items()}
    out = {"seed": seed, "views": window["attempted"],
           "views_per_s": window["metrics"]["render_views_per_s"],
           "per_view": moved,
           "memory_peak_bytes": harness.device_info(device)["memory_peak_bytes"]}
    r.release()
    ref = r.reference()
    out["program"] = r.compare(r.program, ref)
    if control:
        for name, kw in (("control", dict(pr=Precision("bfloat16"))),
                         ("tf32", dict(tf32=True)),
                         ("quick_gelu", dict(quick_gelu=True))):
            out[name] = r.compare(r.reference(**kw), ref)
    out["seconds"] = time.perf_counter() - t0
    del r, ref
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="embed.clip-vit-b16")
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)

    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("calibrate_embed.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(cell, seed, torch.device("cuda"), args.seconds,
                                  seed in controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
