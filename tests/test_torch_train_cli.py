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


def test_jax_phase_b_from_the_port_checkpoint(scene, port_phase_a, tmp_path):
    from langsplat_tpu.cli.train_cli import main as jax_train_main
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


@pytest.mark.parametrize("flags", [["--data_shards", "4"], ["--depth_shards", "2"],
                                   ["--gauss_shards", "2"], ["--port", "6009"],
                                   ["--profile_dir", "trace"], ["--interpret"],
                                   ["--chunk", "128"], ["--dp_views_per_device", "2"],
                                   ["--profile_from", "10"], ["--profile_steps", "3"]])
def test_unported_options_are_refused(scene, tmp_path, flags):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        torch_train_main(["-s", scene, "-m", str(tmp_path / "run"), "--device", "cpu",
                          *PHASE_A, *flags])
