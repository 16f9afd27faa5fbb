"""PyTorch port, multi-device training through the train CLI on the CPU (gloo, one
thread a rank; the CLI starts its ranks itself), on the scene of
`tests/test_data.make_colmap_scene` (4 cameras, 48x64, 50 SfM points):
  - data-parallel phase A over the same view batches: 2 ranks x 2 views, 4 ranks x 1
    view and one process with the 4-view batch, through densifications (one of them
    growing the capacity) and an opacity reset, agree; each run's replicated state is
    bit-equal on every rank;
  - ZeRO-2 with a capacity growth equals the replicated data-parallel run;
  - Gaussian-sharded phase A (shard-local densification, growth) and depth-sharded phase B
    train, the latter like the one-process phase B;
  - the ZeRO-2 and Gaussian-sharded runs track the JAX CLI's with the same flags (its
    tiled backend, --interpret on both sides), and a checkpoint of a sharded run of
    either package resumes in the other;
  - a rank that raises (a view's language features missing) ends the run with a
    non-zero exit code and that rank's traceback;
  - the CLI runs under torchrun, one rank a process.
"""

import os
import signal
import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from langsplat_tpu_torch.cli.train_cli import main as torch_train_main
from langsplat_tpu_torch.models import field_io as tio

from tests.test_data import make_colmap_scene
from tests.test_torch_train_cli import schedule_callback_outside_the_lock

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

PHASE_A = ["--no_include_feature", "--resolution", "1", "--quiet", "--sh_degree", "1",
           "--densify_from_iter", "2", "--densification_interval", "4",
           "--densify_until_iter", "11", "--opacity_reset_interval", "6",
           "--densify_grad_threshold", "0.0000001", "--device", "cpu"]


def run_a(scene, out, iterations, *flags):
    its = str(iterations)
    return torch_train_main(["-s", scene, "-m", out, *PHASE_A, "--iterations", its,
                             "--test_iterations", its, "--save_iterations", its,
                             "--checkpoint_iterations", its, *flags])


@contextmanager
def time_limit(seconds):
    """Fail the test if its body runs longer than `seconds` (the spawned ranks are
    terminated by `launch.spawn` on the way out)."""
    def alarm(*_):
        raise TimeoutError(f"the test ran past its {seconds} s")
    old = signal.signal(signal.SIGALRM, alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_loop") / "scene")
    make_colmap_scene(root, n_cams=4)
    lf_dir = os.path.join(root, "language_features_dim3")
    os.makedirs(lf_dir)
    rng = np.random.default_rng(0)
    for i in range(4):
        np.save(os.path.join(lf_dir, f"img_{i:03d}_s.npy"),
                rng.integers(-1, 4, (4, 48, 64)).astype(np.int32))
        np.save(os.path.join(lf_dir, f"img_{i:03d}_f.npy"),
                rng.normal(size=(4, 3)).astype(np.float32))
    return root


def checkpoint(run_dir, it):
    return tio.load_checkpoint(os.path.join(run_dir, f"chkpnt{it}.npz"), device="cpu")


def assert_ranks_agree(result):
    hashes = {h for r in result["ranks"] for h in r["state_hashes"]}
    assert len(hashes) == 1, hashes
    assert [r["rank"] for r in result["ranks"]] == list(range(len(result["ranks"])))


@pytest.fixture(scope="module")
def dp_runs(scene, tmp_path_factory):
    """Phase A, 12 steps of 4-view batches in three layouts."""
    base = str(tmp_path_factory.mktemp("dp_runs"))
    with time_limit(120):
        return {name: (run_a(scene, os.path.join(base, name), 12, *flags),
                       os.path.join(base, name) + "_-1")
                for name, flags in (
                    ("serial", ["--data_shards", "1", "--dp_views_per_device", "4"]),
                    ("2x2", ["--data_shards", "2", "--dp_views_per_device", "2"]),
                    ("4x1", ["--data_shards", "4"]))}


def test_dp_batches_agree_across_layouts(dp_runs):
    serial, _ = dp_runs["serial"]
    first = [serial["history"][0]]
    for name in ("2x2", "4x1"):
        result, run_dir = dp_runs[name]
        assert_ranks_agree(result)
        assert result["ranks"][0]["backend"] == "gloo"
        first.append(result["history"][0])
        # the same batches: the first step's loss to rounding, then the same run
        np.testing.assert_allclose(result["history"], serial["history"], rtol=1e-4,
                                   err_msg=name)
        field = result["field"]
        assert field.capacity == serial["field"].capacity > 75      # it grew
        assert field.num_alive == serial["field"].num_alive        # same decisions
        np.testing.assert_allclose(field.xyz.numpy(), serial["field"].xyz.numpy(),
                                   atol=1e-4, err_msg=name)
        ck_field, _, _, step, _, _ = checkpoint(run_dir, 12)
        assert step == 12 and torch.equal(ck_field.xyz, field.xyz)
    np.testing.assert_allclose(first[1:], first[0], rtol=1e-6)


def test_zero2_with_growth_matches_replicated(scene, tmp_path):
    # an even capacity at every size: 76, then 152
    flags = ["--data_shards", "2", "--initial_capacity_factor", "1.52",
             "--capacity_growth_factor", "2.0"]
    with time_limit(90):
        rep = run_a(scene, str(tmp_path / "rep"), 8, *flags)
        z2 = run_a(scene, str(tmp_path / "z2"), 8, *flags, "--zero2")
    assert_ranks_agree(z2)
    assert z2["field"].capacity == rep["field"].capacity == 152
    np.testing.assert_allclose(z2["history"], rep["history"], rtol=1e-6)
    for name in ("xyz", "opacity", "scaling", "alive"):
        np.testing.assert_allclose(getattr(z2["field"], name).numpy(),
                                   getattr(rep["field"], name).numpy(), atol=1e-6,
                                   err_msg=name)
    # the gathered checkpoint holds every row of the moments
    _, z2_opt, _, _, _, _ = checkpoint(str(tmp_path / "z2") + "_-1", 8)
    _, rep_opt, _, _, _, _ = checkpoint(str(tmp_path / "rep") + "_-1", 8)
    assert z2_opt["xyz"]["mu"].shape == (152, 3)
    for label, s in rep_opt.items():
        for k, v in s.items():
            np.testing.assert_allclose(z2_opt[label][k].numpy(), v.numpy(), atol=1e-6,
                                       err_msg=f"{label}.{k}")


def test_gauss_sharded_phase_a_densifies_and_grows(scene, tmp_path):
    with time_limit(60):
        result = run_a(scene, str(tmp_path / "gs"), 12, "--gauss_shards", "2")
    assert_ranks_agree(result)
    field = result["field"]
    assert field.capacity > 76 and field.capacity % 2 == 0
    assert 50 < field.num_alive <= field.capacity
    assert all(np.isfinite(result["history"]))
    ck_field, opt_state, stats, _, _, _ = checkpoint(str(tmp_path / "gs") + "_-1", 12)
    assert ck_field.capacity == field.capacity == opt_state["xyz"]["mu"].shape[0]
    assert torch.equal(ck_field.alive, field.alive)


def test_depth_sharded_phase_b_trains_like_one_process(scene, dp_runs, tmp_path):
    _, run_dir = dp_runs["serial"]
    ck = os.path.join(run_dir, "chkpnt12.npz")
    b = ["--resolution", "1", "--iterations", "4", "--quiet", "--feature_level", "1",
         "--start_checkpoint", ck, "--test_iterations", "4", "--save_iterations", "4",
         "--checkpoint_iterations", "4", "--sh_degree", "1", "--device", "cpu"]
    with time_limit(60):
        one = torch_train_main(["-s", scene, "-m", str(tmp_path / "one"), *b])
        depth = torch_train_main(["-s", scene, "-m", str(tmp_path / "d"), *b,
                                  "--depth_shards", "2"])
    assert_ranks_agree(depth)
    assert depth["ranks"][0]["kind"] == "depth"
    np.testing.assert_allclose(depth["history"], one["history"], rtol=1e-5)
    np.testing.assert_allclose(depth["field"].language_feature.numpy(),
                               one["field"].language_feature.numpy(), atol=1e-5)
    assert os.path.exists(str(tmp_path / "d") + "_1/chkpnt4.npz")


@pytest.fixture
def jax_cli(monkeypatch):
    """The JAX CLI's `main`, and the loss history of its last run."""
    import langsplat_tpu.train.loop as jax_loop
    from langsplat_tpu.cli.train_cli import main as jax_main
    from langsplat_tpu.data.prefetch import FeaturePrefetcher

    monkeypatch.setattr(FeaturePrefetcher, "schedule", schedule_callback_outside_the_lock)
    seen = {}
    training = jax_loop.training

    def recording(cfg, **kw):
        result = training(cfg, **kw)
        seen["history"] = result["history"]
        return result
    monkeypatch.setattr(jax_loop, "training", recording)
    return jax_main, seen


SHORT = ["--interpret", "--initial_capacity_factor", "1.52"]


def test_sharded_runs_track_the_jax_cli_and_resume_across(scene, tmp_path, jax_cli):
    """ZeRO-2 phase A in both packages (the same losses), its JAX checkpoint resumed
    Gaussian-sharded by the port, and that port checkpoint resumed by the JAX CLI
    Gaussian-sharded (the same losses as the port's own resume)."""
    jax_main, seen = jax_cli
    z2 = ["--data_shards", "2", "--zero2", *SHORT]
    with time_limit(240):
        jax_main(["-s", scene, "-m", str(tmp_path / "jz2"), *PHASE_A[:-2],
                  "--iterations", "4", "--test_iterations", "99",
                  "--save_iterations", "4", "--checkpoint_iterations", "4", *z2])
        jax_history = seen["history"]
        port = run_a(scene, str(tmp_path / "tz2"), 4, *z2)
        np.testing.assert_allclose(port["history"], jax_history, rtol=1e-4)

        # the JAX package's ZeRO-2 checkpoint, resumed Gaussian-sharded by the port
        jck = str(tmp_path / "jz2") + "_-1/chkpnt4.npz"
        gs = ["--gauss_shards", "2", *SHORT, "--start_checkpoint"]
        port_gs = run_a(scene, str(tmp_path / "tgs"), 6, *gs, jck)
        assert len(port_gs["history"]) == 2
        # the port's Gaussian-sharded checkpoint, resumed Gaussian-sharded by JAX
        tck = str(tmp_path / "tgs") + "_-1/chkpnt6.npz"
        port_again = run_a(scene, str(tmp_path / "tgs2"), 8, *gs, tck)
        jax_main(["-s", scene, "-m", str(tmp_path / "jgs"), *PHASE_A[:-2],
                  "--iterations", "8", "--test_iterations", "99",
                  "--save_iterations", "8", "--checkpoint_iterations", "8", *gs, tck])
    np.testing.assert_allclose(port_again["history"], seen["history"], rtol=1e-4)
    jfield = tio.load_field(str(tmp_path / "jgs") + "_-1/chkpnt8.npz", device="cpu")[0]
    assert jfield.capacity == port_again["field"].capacity


def test_a_failing_rank_ends_the_run(scene, tmp_path):
    """One camera's feature file is missing: the rank that loads it raises while the
    others wait in a collective; the CLI exits non-zero with its traceback."""
    broken = tmp_path / "scene"
    subprocess.run(["cp", "-r", scene, str(broken)], check=True)
    os.remove(broken / "language_features_dim3" / "img_002_f.npy")
    ck = tmp_path / "ck.npz"
    from langsplat_tpu_torch.models.gaussian_field import create_from_pcd
    rng = np.random.default_rng(0)
    field = create_from_pcd(rng.normal(size=(20, 3)).astype(np.float32),
                            rng.uniform(size=(20, 3)).astype(np.float32), sh_degree=1,
                            device="cpu")
    tio.save_field(str(ck), field, step=1, spatial_lr_scale=1.0, active_sh_degree=0)
    cmd = [sys.executable, "-m", "langsplat_tpu_torch.cli.train_cli", "-s", str(broken),
           "-m", str(tmp_path / "run"), "--resolution", "1", "--iterations", "3",
           "--quiet", "--feature_level", "1", "--start_checkpoint", str(ck),
           "--sh_degree", "1", "--device", "cpu", "--data_shards", "4",
           "--test_iterations", "99", "--save_iterations", "3",
           "--checkpoint_iterations", "99"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=90, env=env)
    assert proc.returncode != 0
    assert "RankFailed" in proc.stderr and "img_002_f.npy" in proc.stderr, \
        proc.stderr[-3000:]


def test_the_cli_runs_under_torchrun(scene, tmp_path):
    """Under torchrun each process is one rank (RANK / WORLD_SIZE from the launcher);
    the CLI starts no ranks of its own and rank 0 writes the run."""
    out = str(tmp_path / "run")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "langsplat_tpu_torch.cli.train_cli",
           "-s", scene, "-m", out, *PHASE_A, "--iterations", "4",
           "--test_iterations", "99", "--save_iterations", "4",
           "--checkpoint_iterations", "4", "--data_shards", "2"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("Training complete.") == 1      # rank 0 alone reports
    field, _, _, step, _, _ = checkpoint(out + "_-1", 4)
    assert step == 4 and field.num_alive >= 50
