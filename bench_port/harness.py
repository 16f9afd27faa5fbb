"""One run of one benchmark cell: what is shared by every driver.

A cell is an entry of `workloads` in BENCHMARK.json. It names a configuration (its file
under `configs/`, whose `scene` key picks the maker under `scenes/`) and a traffic mix
(`mixes/<traffic>.json`, whose `kind` picks the driver under `drivers/`). The cell's
comparison limits are in `limits/<cell>.json`, and each per-layer metric has its reader
in `metrics/<metric>.py`. So a later change adds a configuration, a mix, a cell or a
metric by adding files and entries; it edits none that is here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import sys
from dataclasses import dataclass
from pathlib import Path

import torch

from bench_port.scenes import generator

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level module names that may not be loaded in a benchmark process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "langsplat_tpu")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    bench: dict

    @property
    def end_to_end(self) -> list[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    @property
    def per_layer(self) -> list[dict]:
        return [m for m in self.bench["per_layer"] if self.name in m["workloads"]]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT, config_file: str | None = None) -> Cell:
    """The cell `name` of root/BENCHMARK.json, with its files (`config_file` replaces
    the configuration's file, for the tests' small sizes)."""
    bench = _json(root / "BENCHMARK.json")
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == workload["config"])
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    return Cell(name=name, workload=workload,
                config=_json(Path(config_file) if config_file else root / config["file"]),
                mix=_json(BENCH_DIR / "mixes" / f"{workload['traffic']}.json"),
                limits=_json(limits_path) if limits_path.exists() else {}, bench=bench)


def driver(cell: Cell):
    """The driver module of the cell's traffic kind."""
    return importlib.import_module(f"bench_port.drivers.{cell.mix['kind']}")


def metric_reader(name: str):
    """`read(ctx) -> float | None` of metrics/<name>.py."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ---------------------------------------------------------------------------
# Targets: the ground truth the training steps fit, made on the device from the seed
# ---------------------------------------------------------------------------

def gt_images(seed: int, views: int, height: int, width: int, device) -> torch.Tensor:
    """[views, 3, H, W] in [0, 1]: a 1/16-resolution uniform draw, bilinear upsampled
    (smooth colour regions, as photographs have)."""
    gen = generator(seed, 3, device)
    low = torch.rand((views, 3, -(-height // 16), -(-width // 16)), generator=gen,
                     dtype=torch.float32, device=device)
    return torch.nn.functional.interpolate(low, size=(height, width), mode="bilinear",
                                           align_corners=False).contiguous()


def gt_features(seed: int, view: int, channels: int, segments: int, valid: float,
                height: int, width: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(features [C, H, W], mask [1, H, W]) of one view: `segments` Voronoi cells of
    random centres, each with a random unit code and kept (mask 1) with probability
    `valid`, as a SAM level's segment map carries one autoencoder code a mask."""
    gen = generator(seed, 1000 + view, device)
    f32 = dict(dtype=torch.float32, device=device)
    centres = torch.rand((segments, 2), generator=gen, **f32) * torch.tensor(
        [width, height], **f32)
    codes = torch.randn((segments, channels), generator=gen, **f32)
    codes = codes / torch.linalg.vector_norm(codes, dim=1, keepdim=True)
    keep = (torch.rand(segments, generator=gen, **f32) < valid).to(torch.float32)
    ys = torch.arange(height, **f32)[:, None, None]
    xs = torch.arange(width, **f32)[None, :, None]
    d = (xs - centres[:, 0]) ** 2 + (ys - centres[:, 1]) ** 2
    seg = torch.argmin(d, dim=2)
    return (codes[seg].permute(2, 0, 1).contiguous(), keep[seg][None].contiguous())


# ---------------------------------------------------------------------------
# Statistics and the result line
# ---------------------------------------------------------------------------

def percentile(values: list[float], q: int) -> float:
    """The q-th percentile (statistics.quantiles, exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


def log_calls(what: str, seconds: list[float]) -> None:
    """The spread of a window's calls, and its drift from tenth to tenth, on standard
    error: where a run's time went."""
    ms = sorted(s * 1e3 for s in seconds)
    q = statistics.quantiles(ms, n=10) if len(ms) > 1 else ms * 9
    print(f"run.py: {len(ms)} {what} calls, ms median {statistics.median(ms):.3f} "
          f"p10 {q[0]:.3f} p90 {q[8]:.3f} max {ms[-1]:.3f} total {sum(ms):.1f}",
          file=sys.stderr)
    n = len(seconds) // 10
    if n:
        tenths = [statistics.median(seconds[i * n:(i + 1) * n]) * 1e3 for i in range(10)]
        print("run.py: median ms of each tenth of the window in turn: "
              + " ".join(f"{t:.2f}" for t in tenths), file=sys.stderr)


def gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / scale if scale > 0 else (0.0 if a == b else math.inf)


def norm_gaps(program: dict, reference: dict, skip: set = frozenset()) -> float:
    """The worst leaf's gap between the program's norm and the reference's, over the
    reference's norm of that leaf."""
    return max((gap(program[k], reference[k], reference[k]) for k in reference
                if k not in skip), default=0.0)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}). A number without
    a limit, or that is not finite (its value then reads null), fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        finite = math.isfinite(value)
        checks[name] = {"value": value if finite else None, "limit": limit}
        if limit is None or not finite or value > limit:
            ok = False
    return ok, checks


def loaded_forbidden() -> list[str]:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def device_info(device: torch.device) -> dict:
    """The result's `device`: the card's name, one card, and its memory peak so far."""
    cuda = device.type == "cuda"
    return {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
