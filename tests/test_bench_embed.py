"""The benchmark's cell embed.clip-vit-b16 on the CPU at a tiny configuration
(`bench_port/tests/tiny_clip.json`): one window and one traced run give correct results
with the cell's own limits and the result line's metrics, the control and the faults
the limits are set against fail them, a checked view the window lacks fails, the
seeded masks are what the configuration states, and `counts_clip` counts OpenCLIP
ViT-B/16's tower as its docstring's layer-by-layer table sums it."""

import json
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import counts_clip, harness
from bench_port.drivers.embed import view_masks
from bench_port.reference import Precision
from bench_port.run import run
from langsplat_tpu_torch.preprocess.auto_mask import mask_to_bbox

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY = str(ROOT / "bench_port" / "tests" / "tiny_clip.json")
CELL = "embed.clip-vit-b16"
SEED = 2**31 + 977
CPU = torch.device("cpu")
PUBLISHED = json.loads((ROOT / "bench_port" / "configs" / "clip-vit-b16.json").read_text())
CHECKS = {"kept_mismatch", "tile_mismatch", "segmap_mismatch", "embedding_gap",
          "feature_gap"}


def tiny():
    return harness.load_cell(CELL, config_file=TINY)


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_is_correct_and_reports_its_metrics(trace):
    result = run(tiny(), SEED, 1.0, trace, CPU, time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == CHECKS
    if trace:
        # the device metrics need a card's trace; the CPU's gives the rest
        assert {"mfu.embed", "host_syncs.embed"} <= set(result["metrics"])
        assert result["metrics"]["host_syncs.embed"]["value"] == 29
        assert result["attempted"] == tiny().mix["traced_views"]
    else:
        assert set(result["metrics"]) == {"render_views_per_s", "setup_s"}
        assert result["failed"] == 0
    json.dumps(result)


@pytest.mark.parametrize("arith", ["control", "tf32", "quick_gelu"])
def test_the_control_and_the_faults_are_not_correct(arith):
    cell = tiny()
    r = harness.driver(cell).Run(cell, SEED, CPU)
    ref = r.reference()
    kw = dict(control=dict(pr=Precision("bfloat16")), tf32=dict(tf32=True),
              quick_gelu=dict(quick_gelu=True))[arith]
    correct, checks = harness.judge(r.compare(r.reference(**kw), ref), cell.limits)
    assert not correct, checks
    assert checks["embedding_gap"]["value"] > checks["embedding_gap"]["limit"]


def test_a_view_missing_from_the_window_is_not_correct():
    cell = tiny()
    r = harness.driver(cell).Run(cell, SEED, CPU)
    correct, checks = harness.judge(r.compare({}, r.reference()), cell.limits)
    assert not correct and checks["embedding_gap"]["value"] is None
    assert checks["kept_mismatch"]["value"] is None


@pytest.mark.parametrize("view", [0, 3])
def test_the_seeded_masks_are_as_the_configuration_states(view):
    """Counts a level within the configuration's ranges, every mask non-empty with the
    generator's box, a fifth of each level nested in another mask of its level, and
    the scores in their ranges; the same seed gives the same masks."""
    cfg = json.loads(Path(TINY).read_text())
    levels = view_masks(cfg, SEED, view, CPU)
    again = view_masks(cfg, SEED, view, CPU)
    for (lo, hi), recs, recs2 in zip(cfg["masks_per_level"].values(), levels, again):
        assert lo <= len(recs) <= hi
        segs = torch.stack([r["segmentation"] for r in recs])
        assert torch.equal(segs, torch.stack([r["segmentation"] for r in recs2]))
        area = segs.flatten(1).sum(1)
        assert bool((area > 0).all())
        boxes = mask_to_bbox(segs).numpy()
        np.testing.assert_array_equal(np.stack([r["bbox"] for r in recs]), boxes)
        inter = segs.flatten(1).float() @ segs.flatten(1).float().T
        nested = [(inter[i] == area[i]) & (area > area[i]) for i in range(len(recs))]
        assert sum(bool(n.any()) for n in nested) >= round(len(recs) * cfg["nested_share"])
        for r in recs:
            assert 0.7 <= r["predicted_iou"] <= 1.0 and 0.85 <= r["stability_score"] <= 1.0


def test_the_tower_count_equals_the_docstring_table():
    total = re.search(r"^\s*total\s+([\d,]+)$", counts_clip.__doc__, re.M).group(1)
    assert counts_clip.tile_macs(PUBLISHED) == int(total.replace(",", ""))
    assert counts_clip.encoder_pass(PUBLISHED, 3).ops == 6 * counts_clip.tile_macs(PUBLISHED)
    # a level's tiles in passes of 64, the last one partial
    passes = counts_clip.encoder(PUBLISHED, [130])
    assert passes.ops == 2 * 130 * counts_clip.tile_macs(PUBLISHED)
    assert passes.nbytes == sum(counts_clip.encoder_pass(PUBLISHED, n).nbytes
                                for n in (64, 64, 2))


def test_the_weights_count_equals_the_model():
    from langsplat_tpu_torch.models import clip

    with torch.device("meta"):
        model = clip.ClipVision(clip.ClipVisionConfig())
    held = sum(t.numel() for t in model.state_dict().values())
    assert counts_clip.params(PUBLISHED) == held == 86_192_640
