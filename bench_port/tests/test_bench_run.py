"""The run command: it refuses to run without a card, and the result line it prints
has the contract's keys, with the numbers compared last."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench_port import harness
from bench_port.run import run

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
CPU = torch.device("cpu")


def _run_py(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "train-a.synthroom-15k",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_run_fails_without_a_card_instead_of_using_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _run_py(ROOT)
    assert proc.returncode == 2, proc.stderr
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_run_fails_with_the_benchmark_files_alone(tmp_path):
    """A directory that holds only BENCHMARK.json and bench_port/ gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    cell = harness.load_cell("train-b.synthroom-15k",
                             config_file=str(HERE / "tiny_synthroom.json"))
    cell.mix.update(traced_steps=2)
    result = run(cell, 2**31 + 3, 0.2, trace, CPU, time.perf_counter())
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(result["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "mfu.train" in result["metrics"]
        assert result["reruns"] == 0
    else:
        assert set(result["metrics"]) == {"train_step_ms", "setup_s"}
        assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert result["attempted"] >= 1
    json.dumps(result)


def test_the_window_replays_one_epoch_from_the_snapshot():
    """Every replay of the epoch starts from the same state, so its steps repeat their
    losses, and set-up leaves the window no cap to grow."""
    cell = harness.load_cell("train-a.synthroom-15k",
                             config_file=str(HERE / "tiny_synthroom.json"))
    r = harness.driver(cell).Run(cell, 2**31 + 17, CPU)

    def epoch():
        return [(r.next_step(), float(r.last_loss)) for _ in range(r.views)]

    first, second = epoch(), epoch()
    assert first == second
    assert sorted(v for v, _ in first) == list(range(r.views))
    assert r.reruns == 0
