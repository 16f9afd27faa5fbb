"""PyTorch port, training CLI on the CPU: phase A (RGB, with densification and an opacity
reset) and then phase B (language features) on the scene of
`tests/test_data.make_colmap_scene`, writing the JAX package's file layout; the loss
of the first phase-A steps tracks the JAX CLI's; and a phase-A checkpoint from either
package starts phase B in the other."""

import json
import os

import numpy as np
import pytest
import torch

from langsplat_tpu_torch.cli.train_cli import main as torch_train_main
from langsplat_tpu_torch.models import field_io as tio

from tests.test_data import make_colmap_scene

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

PHASE_A = ["--no_include_feature", "--resolution", "1", "--iterations", "30", "--quiet",
           "--densify_from_iter", "5", "--densification_interval", "10",
           "--densify_until_iter", "25", "--opacity_reset_interval", "20",
           "--densify_grad_threshold", "0.0000001", "--test_iterations", "30",
           "--save_iterations", "30", "--checkpoint_iterations", "30",
           "--sh_degree", "1"]


def phase_b(checkpoint):
    return ["--resolution", "1", "--iterations", "10", "--quiet", "--feature_level", "1",
            "--start_checkpoint", checkpoint, "--test_iterations", "10",
            "--save_iterations", "10", "--checkpoint_iterations", "10",
            "--sh_degree", "1"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic COLMAP scene with 4-level seg maps and feature tables per image."""
    root = str(tmp_path_factory.mktemp("train_cli") / "scene")
    make_colmap_scene(root, n_cams=3)
    lf_dir = os.path.join(root, "language_features_dim3")
    os.makedirs(lf_dir)
    rng = np.random.default_rng(0)
    for i in range(3):
        np.save(os.path.join(lf_dir, f"img_{i:03d}_s.npy"),
                rng.integers(-1, 4, (4, 48, 64)).astype(np.int32))
        np.save(os.path.join(lf_dir, f"img_{i:03d}_f.npy"),
                rng.normal(size=(4, 3)).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def port_phase_a(scene, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_a") / "run")
    result = torch_train_main(["-s", scene, "-m", out, "--device", "cpu", *PHASE_A])
    return out + "_-1", result


def test_phase_a_writes_the_jax_layout(port_phase_a):
    run_dir, result = port_phase_a
    for rel in ("chkpnt30.npz", "cfg_args.json", "input.ply", "cameras.json",
                os.path.join("point_cloud", "iteration_30", "point_cloud.ply")):
        assert os.path.exists(os.path.join(run_dir, rel)), rel
    history = result["history"]
    assert len(history) == 30 and all(np.isfinite(history))
    field = result["field"]
    assert field.device.type == "cpu" and field.language_feature is None
    assert tio.checkpoint_has_state(os.path.join(run_dir, "chkpnt30.npz"))
    with open(os.path.join(run_dir, "cfg_args.json")) as f:
        assert json.load(f)["optimization"]["iterations"] == 30
    # densification ran (the threshold is tiny): more Gaussians than the 50 points
    assert 50 < field.num_alive <= field.capacity


def test_phase_a_checkpoint_resumes_in_full(port_phase_a):
    run_dir, result = port_phase_a
    field, opt_state, stats, step, _, deg = tio.load_checkpoint(
        os.path.join(run_dir, "chkpnt30.npz"), device="cpu")
    assert (step, deg) == (30, result["active_sh_degree"])
    for name in ("xyz", "opacity", "alive"):
        assert torch.equal(getattr(field, name), getattr(result["field"], name)), name
    for label, s in result["opt_state"].items():
        for k, v in s.items():
            assert torch.equal(opt_state[label][k], v), (label, k)
    assert torch.equal(stats.denom, result["stats"].denom)


def test_phase_b_from_the_port_checkpoint(scene, port_phase_a, tmp_path):
    run_dir, _ = port_phase_a
    out = str(tmp_path / "run")
    result = torch_train_main(["-s", scene, "-m", out, "--device", "cpu",
                               *phase_b(os.path.join(run_dir, "chkpnt30.npz"))])
    assert os.path.exists(out + "_1/chkpnt10.npz")
    assert len(result["history"]) == 10 and all(np.isfinite(result["history"]))
    lf = result["field"].language_feature
    assert lf is not None and lf.shape == (result["field"].capacity, 3)
    a_field = tio.load_field(os.path.join(run_dir, "chkpnt30.npz"), device="cpu")[0]
    assert torch.equal(result["field"].xyz, a_field.xyz)      # geometry frozen


def schedule_callback_outside_the_lock(self, cam):
    """The JAX package's `FeaturePrefetcher.schedule` with its done-callback registered
    after the lock is released, as the port's is. The JAX one registers it under the
    lock, so a load that has already finished runs the callback in this thread, which
    then waits on that lock forever (ROADMAP.md §3, the prefetcher record)."""
    key = cam.image_name
    if self.cache.get(key) is not None:
        return
    with self._lock:
        if key in self._pending:
            return
        fut = self._pool.submit(self._load, cam)
        self._pending[key] = fut

    def _done(_fut, key=key):
        with self._lock:
            self._pending.pop(key, None)

    fut.add_done_callback(_done)


def test_jax_phase_b_from_the_port_checkpoint(scene, port_phase_a, tmp_path, monkeypatch):
    from langsplat_tpu.cli.train_cli import main as jax_train_main
    from langsplat_tpu.data.prefetch import FeaturePrefetcher

    # the JAX prefetcher's deadlock, which a fast load can hit, would hang the suite
    monkeypatch.setattr(FeaturePrefetcher, "schedule", schedule_callback_outside_the_lock)
    run_dir, _ = port_phase_a
    out = str(tmp_path / "run")
    jax_train_main(["-s", scene, "-m", out, "--interpret",
                    *phase_b(os.path.join(run_dir, "chkpnt30.npz")),
                    "--test_iterations", "99"])
    field, step, *_ = tio.load_field(out + "_1/chkpnt10.npz", device="cpu")
    assert step == 10 and field.language_feature is not None


SHORT_A = ["--no_include_feature", "--resolution", "1", "--iterations", "8", "--quiet",
           "--densify_from_iter", "5", "--densification_interval", "10",
           "--test_iterations", "99", "--save_iterations", "8",
           "--checkpoint_iterations", "8", "--sh_degree", "1"]


@pytest.fixture(scope="module")
def jax_phase_a(scene, tmp_path_factory, monkeypatch_module):
    """The JAX CLI's phase A over 8 steps (no densification yet): (run dir, history)."""
    import langsplat_tpu.train.loop as jax_loop
    from langsplat_tpu.cli.train_cli import main as jax_train_main
    seen = {}

    def training(cfg, **kw):
        result = jax_training(cfg, **kw)
        seen["history"] = result["history"]
        return result

    jax_training = jax_loop.training
    monkeypatch_module.setattr(jax_loop, "training", training)
    out = str(tmp_path_factory.mktemp("jax_a") / "run")
    jax_train_main(["-s", scene, "-m", out, "--interpret", *SHORT_A])
    return out + "_-1", seen["history"]


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_phase_a_loss_tracks_jax(scene, jax_phase_a, tmp_path):
    """Same scene, initial field and camera order: the first steps' losses agree (the
    JAX CLI's CPU path blends with its tiled backend)."""
    _, jax_history = jax_phase_a
    result = torch_train_main(["-s", scene, "-m", str(tmp_path / "run"), "--device",
                               "cpu", *SHORT_A])
    np.testing.assert_allclose(result["history"], jax_history, rtol=1e-3)


def test_port_phase_b_from_a_jax_checkpoint(scene, jax_phase_a, tmp_path):
    run_dir, _ = jax_phase_a
    out = str(tmp_path / "port")
    result = torch_train_main(["-s", scene, "-m", out, "--device", "cpu",
                               *phase_b(os.path.join(run_dir, "chkpnt8.npz"))])
    assert len(result["history"]) == 10 and all(np.isfinite(result["history"]))
    assert os.path.exists(out + "_1/chkpnt10.npz")


def test_train_cli_needs_a_card_unless_asked(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_train_main(["-s", scene, "-m", str(tmp_path / "run"), *PHASE_A])


@pytest.mark.parametrize("flags", [["--chunk", "128"]])
def test_unported_options_are_refused(scene, tmp_path, flags):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        torch_train_main(["-s", scene, "-m", str(tmp_path / "run"), "--device", "cpu",
                          *PHASE_A, *flags])


def test_interpret_trains_like_the_jax_cli(scene, jax_phase_a, tmp_path):
    """--interpret: the tiled backend in both packages, on the same scene, field and
    camera order."""
    _, jax_history = jax_phase_a
    result = torch_train_main(["-s", scene, "-m", str(tmp_path / "run"), "--device",
                               "cpu", "--interpret", *SHORT_A])
    np.testing.assert_allclose(result["history"], jax_history, rtol=1e-4)
    with open(str(tmp_path / "run") + "_-1/cfg_args.json") as f:
        assert json.load(f)["pipeline"]["interpret"] is True


TRACE_A = ["--no_include_feature", "--resolution", "1", "--iterations", "4", "--quiet",
           "--test_iterations", "99", "--save_iterations", "4",
           "--checkpoint_iterations", "99", "--sh_degree", "1"]


@pytest.mark.parametrize("flags,world", [
    (["--data_shards", "4"], 4), (["--depth_shards", "2"], 1),
    (["--gauss_shards", "2"], 2), (["--zero2"], 1), (["--dp_views_per_device", "2"], 1)])
def test_multi_device_options_train(scene, tmp_path, flags, world):
    """The multi-device flags train (on the CPU through gloo, one process a rank);
    as in the JAX package, --depth_shards is phase B's, --zero2 and
    --dp_views_per_device need --data_shards, so in phase A alone they train on one
    device. tests/test_torch_dp_loop.py and test_torch_parallel.py hold the runs."""
    result = torch_train_main(["-s", scene, "-m", str(tmp_path / "run"), "--device", "cpu",
                               *TRACE_A, *flags])
    assert len(result["history"]) == 4 and all(np.isfinite(result["history"]))
    assert result["parallel"]["world"] == world
    assert len(result.get("ranks", [result["parallel"]])) == world
    assert os.path.exists(str(tmp_path / "run") + "_-1/point_cloud/iteration_4/"
                                                  "point_cloud.ply")


@pytest.mark.parametrize("window,iterations", [((2, 2), (2, 4)), ((3, 10), (3, 5))])
def test_profiler_trace_window(scene, tmp_path, window, iterations):
    """--profile_dir writes a torch.profiler trace of iterations [from, from + steps);
    a window that runs past the last step is closed when the loop ends."""
    trace_dir = str(tmp_path / "trace")
    result = torch_train_main(
        ["-s", scene, "-m", str(tmp_path / "run"), "--device", "cpu", *TRACE_A,
         "--profile_dir", trace_dir, "--profile_from", str(window[0]),
         "--profile_steps", str(window[1])])
    trace = result["trace"]
    assert tuple(trace["iterations"]) == iterations
    assert trace["path"] == os.path.join(
        trace_dir, "iterations_{}_{}.pt.trace.json".format(*iterations))
    with open(trace["path"]) as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert "aten::mul" in ops
    # CPU tensors: the plain versions, no kernel launched inside the window
    assert trace["launches"] == {"blend_fwd": 0, "blend_bwd": 0, "segsum": 0,
                                 "preprocess_fwd": 0, "preprocess_bwd": 0, "ssim_fwd": 0,
                                 "ssim_bwd": 0, "bin_count": 0, "bin_rank": 0,
                                 "bin_emit": 0, "bin_sort": 0, "bin_ranges": 0,
                                 "adam_update": 0}
    assert not torch.autograd.profiler._is_profiler_enabled


def test_run_config_round_trips_between_the_packages(tmp_path):
    """cfg_args.json with the trace window and interpret loads in both packages."""
    from dataclasses import replace

    from langsplat_tpu import config as jcfg
    from langsplat_tpu_torch import config as tcfg

    port = replace(tcfg.TrainConfig(), profile_dir="t", profile_from=7, profile_steps=2)
    port.pipeline.interpret = True
    tcfg.save_config(port, str(tmp_path / "port.json"))
    loaded = jcfg.load_config(str(tmp_path / "port.json"))
    assert (loaded.profile_dir, loaded.profile_from, loaded.profile_steps) == ("t", 7, 2)
    assert loaded.pipeline.interpret is True

    jax = replace(jcfg.TrainConfig(), profile_from=9, profile_steps=4)
    jax.pipeline.interpret = True
    jcfg.save_config(jax, str(tmp_path / "jax.json"))
    loaded = tcfg.load_config(str(tmp_path / "jax.json"))
    assert (loaded.profile_from, loaded.profile_steps) == (9, 4)
    assert loaded.pipeline.interpret is True
    assert (tcfg.TrainConfig().profile_from, tcfg.TrainConfig().profile_steps) == (
        jcfg.TrainConfig().profile_from, jcfg.TrainConfig().profile_steps) == (50, 5)
