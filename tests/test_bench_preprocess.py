"""The benchmark's cell preprocess.sam-vit-h on the CPU at a tiny configuration
(`bench_port/tests/tiny_sam.json`): one window and one traced run give correct results
with the cell's own limits and the result line's metrics, the control and the faults
the limits are set against fail them, and `counts_sam` counts SAM ViT-H's encoder as its
docstring's layer-by-layer table sums it."""

import json
import re
import time
from pathlib import Path

import pytest
import torch

from bench_port import counts_sam, harness
from bench_port.reference import Precision
from bench_port.run import run

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY = str(ROOT / "bench_port" / "tests" / "tiny_sam.json")
CELL = "preprocess.sam-vit-h"
SEED = 2**31 + 977
CPU = torch.device("cpu")


def tiny():
    return harness.load_cell(CELL, config_file=TINY)


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_is_correct_and_reports_its_metrics(trace):
    result = run(tiny(), SEED, 1.0, trace, CPU, time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"embedding_gap", "logit_gap", "iou_gap"}
    if trace:
        # the device metrics need a card's trace; the CPU's gives the rest
        assert {"mfu.preprocess", "host_syncs.preprocess"} <= set(result["metrics"])
        assert result["attempted"] == tiny().mix["traced_views"]
    else:
        assert set(result["metrics"]) == {"render_views_per_s", "setup_s"}
        assert result["failed"] == 0
    json.dumps(result)


@pytest.mark.parametrize("arith", ["control", "tf32", "no_global_rel_pos"])
def test_the_control_and_the_faults_are_not_correct(arith):
    cell = tiny()
    r = harness.driver(cell).Run(cell, SEED, CPU)
    ref = r.reference()
    kw = dict(control=dict(pr=Precision("bfloat16")), tf32=dict(tf32=True),
              no_global_rel_pos=dict(global_rel_pos=False))[arith]
    correct, checks = harness.judge(r.compare(r.reference(**kw), ref), cell.limits)
    assert not correct, checks


def test_a_view_missing_from_the_window_is_not_correct():
    cell = tiny()
    r = harness.driver(cell).Run(cell, SEED, CPU)
    correct, checks = harness.judge(r.compare({}, r.reference()), cell.limits)
    assert not correct and checks["embedding_gap"]["value"] is None


def test_the_encoder_count_equals_the_docstring_table():
    cfg = json.loads((ROOT / "bench_port" / "configs" / "sam-vit-h.json").read_text())
    total = re.search(r"^\s*total\s+([\d,]+)$", counts_sam.__doc__, re.M).group(1)
    table = int(total.replace(",", ""))
    assert abs(counts_sam.encoder_macs(cfg) - table) <= 1e-3 * table
    assert counts_sam.encoder(cfg).ops == 2 * counts_sam.encoder_macs(cfg)


def test_the_encoder_weights_count_equals_the_model():
    from langsplat_tpu_torch.models import sam

    cfg = json.loads((ROOT / "bench_port" / "configs" / "sam-vit-h.json").read_text())
    with torch.device("meta"):
        model = sam.Sam(sam.SamConfig())
    held = sum(t.numel() for k, t in model.state_dict().items()
               if k.startswith("image_encoder."))
    assert counts_sam.encoder_params(cfg) == held == 637_026_048
