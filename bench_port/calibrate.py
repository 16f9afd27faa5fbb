"""The readings the comparison's limits are set from, for one cell, on the card.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 1]

For each seed, one set-up of the cell as a benchmark run makes it, a short window
(the render cell's checked views come from it), and the numbers that decide `correct`:
the program against the reference (the lower reading, over a dozen seeds or more).
For each control seed also the control, the reference in bfloat16 put in the program's
place, and for a training cell the fault "half of the batch left out": the reference
with the loss over the upper half of the image rows alone, in the program's place (the
upper readings); for a training cell also the raw readings (each step's loss, each
leaf's norms) of each side. A step that returns its state unchanged reads 1 on grad_gap and
change_gap by their definition and needs no run. One JSON line a seed; benchmark runs
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

    t0 = time.perf_counter()
    r = harness.driver(cell).Run(cell, seed, device)
    if cell.mix["kind"] == "render":
        r.window(seconds)
    r.release()
    ref = r.reference()
    train = cell.mix["kind"] == "train"
    out = {"seed": seed, "program": r.compare(r.program, ref)}
    raw = {"program": r.program, "reference": ref} if train else {}
    if control:
        ctrl = r.reference(Precision("bfloat16"))
        out["control"] = r.compare(ctrl, ref)
        if train:
            half = r.reference(loss_rows=slice(0, cell.config["height"] // 2))
            out["half_batch"] = r.compare(half, ref)
            raw.update(control=ctrl, half_batch=half)
    if raw:
        out["raw"] = raw
    out["seconds"] = time.perf_counter() - t0
    del r
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)

    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        print(json.dumps(readings(cell, seed, torch.device("cuda"), args.seconds,
                                  seed in controls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
