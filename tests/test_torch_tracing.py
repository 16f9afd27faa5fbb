"""The port's tracer (`langsplat_tpu_torch/utils/tracing.py`) on the CPU, with the plain
versions of the kernels, on the benchmark's tiny box field (64x48, 3,000 Gaussians):

- with tracing off nothing is recorded and a profiler trace holds no `langsplat.*` span;
- under torch.profiler, `train_step_rgb`, `train_step_feature`, `render_full` and the
  loop's iterations give the documented span tree, and the exported Chrome trace holds
  the spans inside the profiled window;
- the counters move as documented (`host_syncs` per site, `render_attempts` against a
  forced retry, `step_reruns`), and the old counter names are views of the registry;
- the loop's discard-and-re-run rule re-runs a step at grown caps until it drops
  nothing, raises at both caps, or keeps the truncated step when asked to;
- outputs are bit-equal with tracing on and off;
- each per-layer reader of the benchmark (`bench_port/metrics/`) gives its documented
  number on a hand-made session, and None where it has nothing to read.
"""

import json
import os
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench_port import harness, scenes
from bench_port.drivers import program
from langsplat_tpu_torch.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                                        TrainConfig)
from langsplat_tpu_torch.data import cameras
from langsplat_tpu_torch.ops import _build
from langsplat_tpu_torch.train import loop, trainer
from langsplat_tpu_torch.train.densify import DensifyStats
from langsplat_tpu_torch.utils import tracing
from langsplat_tpu_torch.utils.tracing import COUNTERS, Session, Span

from tests.test_data import make_colmap_scene

torch.set_num_threads(1)

CPU = torch.device("cpu")
TINY_BOX = (Path(__file__).resolve().parent.parent / "bench_port" / "tests"
            / "tiny_box.json")
#: the sync spans of one binning on the culled path (tile cap <= 128) and on the
#: unculled one, with the syncs each stands for
CULLED = {"sync.binning.threshold": 2, "sync.binning.nonzero": 1, "sync.binning.total": 1,
          "sync.binning.kept": 1, "sync.binning.dropped": 1}
UNCULLED = {"sync.binning.repeat_interleave": 2, "sync.binning.total": 1,
            "sync.binning.kept": 1, "sync.binning.dropped": 1}
#: syncs a span name stands for, where not 1
WEIGHT = {"sync.binning.repeat_interleave": 2}
#: binning's entry points on the card (csrc/binning.cu), none launched on the CPU
BIN_KERNELS = ("bin_count", "bin_rank", "bin_emit", "bin_sort", "bin_ranges")


@pytest.fixture(scope="module")
def box():
    cell = harness.load_cell("train-a.lerf-1m", config_file=str(TINY_BOX))
    scene = scenes.make(cell.config, 5, CPU)
    return dict(cams=program.cameras(scene), pipe=program.pipeline(cell.config),
                leaves=scene.leaves, extent=scene.extent())


def step_inputs(box, phase, max_tiles=None):
    """One training step of `phase` on view 0 of the box, as a function."""
    feature = phase == "B"
    field = program.field_of(box["leaves"], feature)
    optimizer = trainer.make_optimizer(OptimizationConfig(), box["extent"], feature)
    state = optimizer.init(trainer.extract_params(field, feature))
    stats = DensifyStats.zeros(field.capacity, CPU)
    cam = box["cams"][0]
    mats = program.matrices(cam, CPU)
    settings = loop.make_settings(cam, box["pipe"], 3, feature, field.capacity,
                                  max_tiles=max_tiles)
    gen = torch.Generator().manual_seed(3)
    bg = torch.zeros(3)
    if feature:
        gt = torch.rand((3, cam.height, cam.width), generator=gen)
        mask = (torch.rand((1, cam.height, cam.width), generator=gen) < 0.8).float()
        return lambda: trainer.train_step_feature(field, state, stats, *mats, gt, mask, bg,
                                                  settings=settings, optimizer=optimizer)
    gt = torch.rand((3, cam.height, cam.width), generator=gen)
    return lambda: trainer.train_step_rgb(field, state, stats, *mats, gt, bg,
                                          settings=settings, optimizer=optimizer,
                                          lambda_dssim=0.2)


def render_call(box, view=1, **start):
    field = program.field_of(box["leaves"], True)
    return lambda: loop.render_full(field, box["cams"][view], box["pipe"], 3, True,
                                    [0.0, 0.0, 0.0], device="cpu", **start)


def traced(fn):
    """fn() under a CPU torch.profiler, one session: (its result, the session, the
    counters' moves, the profiler)."""
    tracing.end_session()
    before = dict(COUNTERS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.window"):
            out = fn()
    moved = {k: v - before[k] for k, v in COUNTERS.items()}
    return out, tracing.session(), moved, prof


def tensors(x):
    """The tensors of a step's or render's output, in a fixed order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in tensors(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    if hasattr(x, "__dataclass_fields__"):
        return [t for k in sorted(x.__dataclass_fields__) for t in tensors(getattr(x, k))]
    return []


def children(s: Session, span: Span) -> list[Span]:
    return [c for c in s.spans if c.parent == span.id]


def assert_well_formed(s: Session):
    """One root id a call, children inside their parent, self times that add up."""
    by_id = {sp.id: sp for sp in s.spans}
    assert len(by_id) == len(s.spans)
    for sp in s.spans:
        assert sp.end_ns is not None and sp.end_ns >= sp.start_ns
        if sp.parent is None:
            continue
        parent = by_id[sp.parent]
        assert sp.root == parent.root
        assert parent.start_ns <= sp.start_ns and sp.end_ns <= parent.end_ns
    own = s.self_ns()
    assert all(v >= 0 for v in own.values())
    for root in s.roots():
        ids = set()
        frontier = [root.id]
        while frontier:
            i = frontier.pop()
            ids.add(i)
            frontier += [c.id for c in s.spans if c.parent == i]
        assert sum(own[i] for i in ids) == root.ns
        assert {by_id[i].root for i in ids} == {root.root}


def names(spans) -> list[str]:
    return [sp.name for sp in spans]


def sync_counts(s: Session) -> dict:
    out = {}
    for sp in s.spans:
        if sp.name.startswith("sync."):
            out[sp.name] = out.get(sp.name, 0) + WEIGHT.get(sp.name, 1)
    return out


def test_off_records_nothing(box):
    step, render = step_inputs(box, "A"), render_call(box)
    traced(step)                    # a session to compare against
    before = tracing.session()
    syncs = COUNTERS["host_syncs"]
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("a") is tracing.span("b")        # one shared no-op
    step()
    render()
    after = tracing.session()
    assert [(s.name, s.id) for s in after.spans] == [(s.name, s.id) for s in before.spans]
    assert after.counts == before.counts
    assert COUNTERS["host_syncs"] > syncs                # counters are always on
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert not any(e.key.startswith(tracing.PREFIX) for e in prof.key_averages())


def test_a_session_is_a_profiled_period(box):
    """The first span after a span site reached with tracing off starts a new session;
    two windows with none between are one."""
    step = step_inputs(box, "A")
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    step()                                  # tracing off: the session ends
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    assert names(tracing.session().roots()) == ["train_step"]
    with profile(activities=[ProfilerActivity.CPU]):
        step()
    assert names(tracing.session().roots()) == ["train_step"] * 2


@pytest.mark.parametrize("phase", ["A", "B"])
def test_train_step_span_tree(box, phase):
    _, s, moved, _ = traced(step_inputs(box, phase))
    assert_well_formed(s)
    (root,) = s.roots()
    assert root.name == "train_step" and root.root == root.id
    want = ["render", "loss", "backward", "optimizer"] + (["stats"] if phase == "A" else [])
    assert names(children(s, root)) == want
    (render,) = [c for c in children(s, root) if c.name == "render"]
    assert names(children(s, render)) == ["preprocess", "binning", "blend"]
    (binning,) = [c for c in children(s, render) if c.name == "binning"]
    assert all(n.startswith("sync.binning.") for n in names(children(s, binning)))
    if phase == "A":
        (stats,) = [c for c in children(s, root) if c.name == "stats"]
        assert names(children(s, stats)) == ["sync.stats.scale"]
    want_syncs = dict(CULLED, **({"sync.stats.scale": 1} if phase == "A" else {}))
    assert sync_counts(s) == want_syncs
    assert moved["host_syncs"] == s.count("host_syncs") == sum(want_syncs.values())
    assert not any(sp.name.startswith("bench.") for sp in s.spans)


def test_host_syncs_per_site_on_the_unculled_path(box):
    """Past a tile cap of 128 binning takes repeat_interleave, two syncs in one span."""
    _, s, moved, _ = traced(step_inputs(box, "A", max_tiles=256))
    assert sync_counts(s) == dict(UNCULLED, **{"sync.stats.scale": 1})
    assert moved["host_syncs"] == 6


@pytest.mark.parametrize("start", [{}, dict(budget=512, max_tiles=2)])
def test_render_full_span_tree_and_attempts(box, monkeypatch, start):
    """render_full from the policy's caps, and from a budget of 512 and a tile cap of 2
    (the forced retry of tests/test_torch_render_budget.py): one `attempt` a try, each
    holding the render and the read of its drop counters, counted in
    `render_attempts`."""
    renders = []
    inner = loop.render

    def counting(*args, **kw):
        renders.append(1)
        return inner(*args, **kw)

    monkeypatch.setattr(loop, "render", counting)
    _, s, moved, _ = traced(render_call(box, **start))
    assert_well_formed(s)
    (root,) = s.roots()
    assert root.name == "render_full"
    kids = children(s, root)
    attempts = [c for c in kids if c.name == "attempt"]
    assert names(kids) == (["sync.render_full.camera"] * 3 + ["sync.render_full.bg"]
                           + ["attempt"] * len(attempts))
    assert moved["render_calls"] == s.count("render_calls") == 1
    assert moved["render_attempts"] == s.count("render_attempts") == len(attempts)
    assert len(attempts) == len(renders)
    assert (len(attempts) > 1) == bool(start)
    for a in attempts:
        assert names(children(s, a)) == ["render", "sync.render_full.dropped",
                                         "sync.render_full.rect_dropped"]
    per_attempt = sum(CULLED.values()) + 2
    assert moved["host_syncs"] == 4 + per_attempt * len(attempts)


def test_chrome_trace_holds_the_spans_in_the_window(box, tmp_path):
    _, s, _, prof = traced(step_inputs(box, "A"))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (window,) = [e for e in events if e["name"] == "test.window"]
    ours = [e for e in events if e["name"].startswith(tracing.PREFIX)]
    assert sorted(e["name"] for e in ours) == sorted(tracing.PREFIX + sp.name
                                                     for sp in s.spans)
    for e in ours:
        assert e["cat"] == "user_annotation"
        assert window["ts"] <= e["ts"] and e["ts"] + e["dur"] <= window["ts"] + window["dur"]


@pytest.mark.parametrize("what", ["A", "B", "render"])
def test_outputs_bit_equal_with_tracing_on_and_off(box, what):
    call = render_call(box, budget=512, max_tiles=2) if what == "render" else step_inputs(
        box, what)
    off = call()
    on, s, _, _ = traced(call)
    assert s.spans
    a, b = tensors(off), tensors(on)
    assert len(a) == len(b) > 4
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_counter_views_share_the_registry(monkeypatch):
    monkeypatch.setitem(COUNTERS, "launches.segsum", 5)
    monkeypatch.setitem(COUNTERS, "feature_loads.numpy", 7)
    assert _build.LAUNCHES["segsum"] == 5 and cameras.FEATURE_LOADS["numpy"] == 7
    _build.LAUNCHES["segsum"] += 1
    assert COUNTERS["launches.segsum"] == 6
    assert set(_build.LAUNCHES) == {"blend_fwd", "blend_bwd", "segsum", "preprocess_fwd",
                                    "preprocess_bwd", "ssim_fwd", "ssim_bwd", *BIN_KERNELS,
                                    "adam_update"}
    assert set(cameras.FEATURE_LOADS) == {"native", "numpy"}
    assert dict(_build.LAUNCHES) == {k[len("launches."):]: v for k, v in COUNTERS.items()
                                     if k.startswith("launches.")}


def test_loop_iterations_in_a_trace_window(tmp_path):
    """training() with a trace window over iterations 2-3 and a tile cap of 1, so steps
    re-run at grown caps: each iteration is a root whose call id is its number, holding
    its train steps, the step's reads and the camera copies; `step_reruns` counts the
    discarded steps; the window returns the session's counters."""
    root = str(tmp_path / "scene")
    make_colmap_scene(root, n_cams=3)
    cfg = TrainConfig(model=ModelConfig(source_path=root, model_path="", resolution=1,
                                        sh_degree=1),
                      pipeline=PipelineConfig(max_tiles_per_gaussian=1),
                      optimization=replace(OptimizationConfig(), iterations=4,
                                           include_feature=False),
                      test_iterations=(99,), save_iterations=(99,),
                      checkpoint_iterations=(99,), quiet=True,
                      profile_dir=str(tmp_path / "trace"), profile_from=1,
                      profile_steps=3)
    result = loop.training(cfg, device="cpu")
    s = tracing.session()
    assert_well_formed(s)
    roots = s.roots()
    assert names(roots) == ["iteration"] * 3
    assert [r.root for r in roots] == [1, 2, 3]
    steps = [c for r in roots for c in children(s, r) if c.name == "train_step"]
    counters = result["trace"]["counters"]
    assert counters["step_reruns"] == len(steps) - 3 > 0
    assert counters == s.counts
    assert result["trace"]["launches"] == {"blend_fwd": 0, "blend_bwd": 0, "segsum": 0,
                                           "preprocess_fwd": 0, "preprocess_bwd": 0,
                                           "ssim_fwd": 0, "ssim_bwd": 0,
                                           **dict.fromkeys(BIN_KERNELS, 0),
                                           "adam_update": 0}
    kids = set(names(children(s, roots[0])))
    assert {"train_step", "sync.step.dropped", "sync.step.rect_dropped", "sync.step.loss",
            "sync.camera"} <= kids
    assert sum(WEIGHT.get(sp.name, 1) for sp in s.spans
               if sp.name.startswith("sync.")) == counters["host_syncs"]
    with open(result["trace"]["path"]) as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "langsplat.iteration" for e in events) == 3


@pytest.mark.parametrize("case", ["reruns", "raises", "truncates"])
def test_rerun_until_nothing_drops(case):
    """`loop.rerun_until_nothing_drops` with a step that reports a set sequence of
    (dropped instances, dropped rect positions): max_tiles 2 -> 4 -> 8 -> 12 (the 4x3
    grid of a 64x48 view) and the budget 8,192 -> 12,288 -> 20,480 -> 32,768 (4 x
    capacity, in granules of 4,096) grow with what drops, and each re-run is counted;
    past both caps the rule raises with the caps in its message, or, with
    allow_budget_truncation, logs a warning and keeps the last step."""
    class Cam:
        width, height = 64, 48

    pipe = PipelineConfig(budget_factor=4, max_tiles_per_gaussian=2,
                          allow_budget_truncation=case == "truncates")
    capacity = 8192
    budget, tmax = loop.BudgetPolicy(pipe, capacity), loop.TmaxPolicy(pipe, [Cam()])
    drops = [(5, 0), (0, 3), (2, 1), (0, 0)] if case == "reruns" else [(1, 1)] * 6
    caps, lines = [], []

    def attempt(b, t):
        caps.append((b, t))
        d, r = drops[len(caps) - 1]
        return trainer.StepOutput(*[None] * 6, torch.tensor(d), torch.tensor(r))

    reruns = COUNTERS["step_reruns"]
    if case == "raises":
        with pytest.raises(RuntimeError, match=r"\[iter 7\] 1 instances dropped at the "
                           r"budget cap 32768 and 1 rect positions dropped at "
                           r"max_tiles=12 \(capacity 8192, budget_factor 4\)"):
            loop.rerun_until_nothing_drops(attempt, budget, tmax, capacity, pipe,
                                           lines.append, 7)
    else:
        out, dropped = loop.rerun_until_nothing_drops(attempt, budget, tmax, capacity,
                                                      pipe, lines.append, 7)
        assert int(out.dropped) == dropped == drops[len(caps) - 1][0]
    if case == "reruns":
        assert caps == [(8192, 2), (12288, 2), (12288, 4), (20480, 8)]
        assert lines == ["[iter 7] instance budget -> 12288 (5 dropped)",
                         "[iter 7] max_tiles_per_gaussian -> 4 (3 rect positions dropped)",
                         "[iter 7] max_tiles_per_gaussian -> 8 (1 rect positions dropped)",
                         "[iter 7] instance budget -> 20480 (2 dropped)"]
    else:
        assert caps == [(8192, 2), (12288, 4), (20480, 8), (32768, 12)]
        assert len(lines) == 6 + (case == "truncates")
        assert lines[-1].startswith("WARNING (truncated step): [iter 7] 1 instances "
                                    "dropped at the budget cap 32768") == (
            case == "truncates")
    assert COUNTERS["step_reruns"] - reruns == len(caps) - 1


# ---------------------------------------------------------------------------
# The benchmark's per-layer readers on a hand-made session
# ---------------------------------------------------------------------------

def made_session(root_name: str, calls: int) -> Session:
    """`calls` roots of 10 ms, each with a render (4 ms: preprocess 1, binning 2 of which
    a sync 0.5, blend 0.5), loss 1, backward 2, optimizer 1.5, stats 0.25 with a sync
    0.125, and a sync 0.25 of its own; counters: 6 syncs, 4 render calls, 5 attempts."""
    ms = 1_000_000
    spans, sid = [], 0

    def add(name, parent, start, dur):
        nonlocal sid
        sp = Span(name, sid, None if parent is None else parent.id,
                  sid if parent is None else parent.root, start, start + dur)
        spans.append(sp)
        sid += 1
        return sp

    for i in range(calls):
        t = i * 20 * ms
        root = add(root_name, None, t, 10 * ms)
        render = add("render", root, t, 4 * ms)
        add("preprocess", render, t, 1 * ms)
        binning = add("binning", render, t + 1 * ms, 2 * ms)
        add("sync.binning.nonzero", binning, t + 1 * ms, ms // 2)
        add("blend", render, t + 3 * ms, ms // 2)
        add("loss", root, t + 4 * ms, 1 * ms)
        add("backward", root, t + 5 * ms, 2 * ms)
        add("optimizer", root, t + 7 * ms, 3 * ms // 2)
        stats = add("stats", root, t + 17 * ms // 2, ms // 4)
        add("sync.stats.scale", stats, t + 17 * ms // 2, ms // 8)
        add("sync.step.dropped", root, t + 9 * ms, ms // 4)
    counts = {"host_syncs": 6 * calls, "render_calls": 4, "render_attempts": 5}
    return Session(spans, counts)


#: reader -> (kind, root span, its documented number on made_session(., 4) a call)
READERS = {
    "host_syncs.train": ("train", "train_step", 6.0),
    "sync_wait_ms.train": ("train", "train_step", 0.875),
    "render_host_ms.train": ("train", "train_step", 3.5),
    "loss_host_ms.train": ("train", "train_step", 1.0),
    "backward_host_ms.train": ("train", "train_step", 2.0),
    "optimizer_host_ms.train": ("train", "train_step", 1.5),
    "stats_host_ms.train": ("train", "train_step", 0.125),
    "host_syncs.render": ("render", "render_full", 6.0),
    "sync_wait_ms.render": ("render", "render_full", 0.875),
    "render_attempts.render": ("render", "render_full", 1.25),
    "preprocess_host_ms.render": ("render", "render_full", 1.0),
    "binning_host_ms.render": ("render", "render_full", 1.5),
    "blend_host_ms.render": ("render", "render_full", 0.5),
}


def test_every_new_metric_has_a_reader_and_an_entry():
    bench = json.loads((Path(harness.ROOT) / "BENCHMARK.json").read_text())
    listed = {m["name"]: m for m in bench["per_layer"]}
    for name, (kind, _, _) in READERS.items():
        assert (Path(harness.BENCH_DIR) / "metrics" / f"{name}.py").exists()
        assert listed[name]["source"] in ("program_span", "program_counter")
        assert name.endswith("." + kind)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_made_session(monkeypatch, name):
    kind, root, value = READERS[name]
    read = harness.metric_reader(name)
    ctx = dict(kind=kind, reading=dict(calls=4))
    monkeypatch.setattr(tracing, "session", lambda: made_session(root, 4))
    assert read(ctx) == pytest.approx(value, rel=1e-12)
    # the other kind, a root count that is not the calls', an empty session
    assert read(dict(ctx, kind="render" if kind == "train" else "train")) is None
    assert read(dict(ctx, reading=dict(calls=3))) is None
    other = "render_full" if root == "train_step" else "train_step"
    monkeypatch.setattr(tracing, "session", lambda: made_session(other, 4))
    assert read(ctx) is None
    monkeypatch.setattr(tracing, "session", lambda: Session())
    assert read(ctx) is None
    # a program without the tracer
    monkeypatch.setitem(sys.modules, "langsplat_tpu_torch.utils.tracing", None)
    assert read(ctx) is None


def test_stats_reader_reads_nothing_in_phase_b(monkeypatch):
    s = made_session("train_step", 4)
    s = Session([sp for sp in s.spans if not sp.name.endswith("stats") and
                 sp.name != "sync.stats.scale"], s.counts)
    monkeypatch.setattr(tracing, "session", lambda: s)
    read = harness.metric_reader("stats_host_ms.train")
    assert read(dict(kind="train", reading=dict(calls=4))) is None
    assert harness.metric_reader("loss_host_ms.train")(
        dict(kind="train", reading=dict(calls=4))) == pytest.approx(1.0)


def test_no_span_is_named_like_the_harness(box):
    _, s, _, _ = traced(render_call(box, budget=512, max_tiles=2))
    assert s.spans and not any(sp.name.startswith("bench.") for sp in s.spans)
    assert os.path.commonprefix([tracing.PREFIX, "bench."]) == ""


def test_trace_layers_puts_idle_gaps_down_to_the_innermost_span():
    """scripts/trace_layers.py on a hand-made Chrome trace: each gap goes to the
    innermost `langsplat.*` span holding the launch of the work that ends it."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    try:
        import trace_layers
    finally:
        sys.path.pop(0)

    def x(name, cat, ts, dur, **args):
        return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=1, args=args)

    events = [x(trace_layers.trace.WINDOW, "user_annotation", 0, 100),
              # on a CUDA device each annotation is also on the device's timeline
              x(trace_layers.trace.WINDOW, "gpu_user_annotation", 3, 100),
              x("langsplat.train_step", "gpu_user_annotation", 4, 50),
              x("langsplat.train_step", "user_annotation", 0, 90),
              x("langsplat.render", "user_annotation", 1, 40),
              x("langsplat.binning", "user_annotation", 10, 20),
              x("langsplat.backward", "user_annotation", 50, 30),
              # launches (host) and the work they launched (device)
              x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1),
              x("k1", "kernel", 5, 10, correlation=1),
              x("cudaLaunchKernel", "cuda_runtime", 12, 1, correlation=2),
              x("k2", "kernel", 20, 5, correlation=2),       # gap 15 -> 20
              x("cudaLaunchKernel", "cuda_runtime", 60, 1, correlation=3),
              x("k3", "kernel", 61, 4, correlation=3),       # gap 25 -> 61
              x("cudaLaunchKernel", "cuda_runtime", 95, 1, correlation=4),
              x("k4", "kernel", 96, 2, correlation=4)]       # gap 65 -> 96
    r = trace_layers.read(events, calls=1)
    by = r["by_span"]
    assert by["train_step/render"] == dict(idle_ms=0.0, device_ms=0.01, launches=1)
    assert by["train_step/render/binning"]["idle_ms"] == pytest.approx(0.005)
    assert by["train_step/backward"]["idle_ms"] == pytest.approx(0.036)
    assert by[trace_layers.OUTSIDE]["idle_ms"] == pytest.approx(0.031)
    assert r["busy_ms"] == pytest.approx(0.021)
    assert r["idle_share"] == pytest.approx(1 - 21 / 100)
