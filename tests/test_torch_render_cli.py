"""PyTorch port, render CLI and field files: a model written by the JAX package renders
through the port's CLI (on the CPU) to the JAX CLI's `renders_npy` within 3e-5, for RGB
and for language features; JAX checkpoints and PLY files load in the port, and the
port's writers produce files the JAX package reads (the PLY byte for byte)."""

import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.cli.render_cli import main as jax_render_main
from langsplat_tpu.data.dataset import read_colmap_scene
from langsplat_tpu.models import field_io as jio
from langsplat_tpu.models.gaussian_field import GaussianField as JaxField
from langsplat_tpu_torch.cli.render_cli import main as torch_render_main
from langsplat_tpu_torch.models import field_io as tio
from langsplat_tpu_torch.models.gaussian_field import FIELD_NAMES, from_numpy

from tests.test_data import make_colmap_scene

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 3e-5
ITER = 7


def params_in_front_of(cams, per_cam=60, cap_extra=8, seed=0):
    """Field leaves (numpy, sh_degree 3, F=3) with Gaussians placed in front of each
    camera, plus a few dead capacity slots."""
    rng = np.random.default_rng(seed)
    pts = []
    for cam in cams:
        z = rng.uniform(3, 6, (per_cam, 1))
        xy = rng.uniform(-0.5, 0.5, (per_cam, 2)) * z
        p_cam = np.concatenate([xy, z], axis=1)
        pts.append((p_cam - cam.T) @ cam.R.T)     # world = R (p_cam - T)
    n = per_cam * len(cams)
    cap = n + cap_extra
    xyz = np.zeros((cap, 3))
    xyz[:n] = np.concatenate(pts)
    params = dict(xyz=xyz, features_dc=rng.normal(size=(cap, 1, 3)),
                  features_rest=0.2 * rng.normal(size=(cap, 15, 3)),
                  scaling=np.log(rng.uniform(0.05, 0.3, (cap, 3))),
                  rotation=rng.normal(size=(cap, 4)), opacity=rng.normal(size=(cap, 1)),
                  language_feature=rng.normal(size=(cap, 3)))
    params = {k: v.astype(np.float32) for k, v in params.items()}
    params["alive"] = np.arange(cap) < n
    return params


def jax_field(params):
    return JaxField(**{k: None if params.get(k) is None else jnp.asarray(params[k])
                       for k in FIELD_NAMES})


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A COLMAP scene and a model dir written by the JAX package."""
    root = tmp_path_factory.mktemp("cli")
    scene = str(root / "scene")
    make_colmap_scene(scene)
    params = params_in_front_of(read_colmap_scene(scene).train_cameras)
    model_dir = root / "model"
    field = jax_field(params)
    jio.save_ply(field, str(model_dir / "point_cloud" / f"iteration_{ITER}" /
                            "point_cloud.ply"))
    jio.save_checkpoint(str(model_dir / f"chkpnt{ITER}.npz"), field, (), (), step=ITER,
                        spatial_lr_scale=1.0, active_sh_degree=3)
    return scene, model_dir, params


def renders(model_dir):
    """(renders_npy arrays, gt_npy arrays) of the train split, in view order."""
    base = os.path.join(model_dir, "train", f"ours_{ITER}")
    return tuple([np.load(os.path.join(base, sub, f))
                  for f in sorted(os.listdir(os.path.join(base, sub)))]
                 for sub in ("renders_npy", "gt_npy"))


@pytest.mark.parametrize("include_feature", [False, True])
def test_render_cli_matches_jax(model, tmp_path, include_feature):
    scene, model_dir, _ = model
    flag = ["--include_feature"] if include_feature else []
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    shutil.copytree(model_dir, jdir)
    shutil.copytree(model_dir, tdir)
    jax_render_main(["-m", jdir, "-s", scene, "--interpret", "--skip_test", *flag])
    torch_render_main(["-m", tdir, "-s", scene, "--device", "cpu", "--skip_test", *flag])
    (jr, jgt), (tr, tgt) = renders(jdir), renders(tdir)
    assert len(tr) == len(jr) == 3
    for a, b in zip(tr, jr):
        assert a.shape == b.shape == (48, 64, 3)
        np.testing.assert_allclose(a, b, atol=ATOL)
    assert max(float(np.abs(r).max()) for r in tr) > 0.1   # something was rendered
    assert len(tgt) == len(jgt) == (0 if include_feature else 3)
    for a, b in zip(tgt, jgt):
        np.testing.assert_array_equal(a, b)
    for sub in ("renders", "gt", "renders_npy", "gt_npy"):
        assert os.path.isdir(os.path.join(tdir, "train", f"ours_{ITER}", sub))


def test_render_cli_needs_a_card_unless_asked(model, tmp_path, monkeypatch):
    scene, model_dir, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_render_main(["-m", str(model_dir), "-s", scene, "--skip_test"])


@pytest.mark.parametrize("flags", [["--chunk", "128"], ["--dp_views_per_device", "2"]])
def test_render_cli_refuses_jax_only_flags(model, flags):
    """A JAX command line that asks for a Pallas chunk or several views per device fails
    with a message naming the flag, rather than running as something else."""
    scene, model_dir, _ = model
    with pytest.raises(NotImplementedError, match=flags[0]):
        torch_render_main(["-m", str(model_dir), "-s", scene, "--skip_test",
                           "--device", "cpu", *flags])


def test_ply_is_byte_equal_to_jax_writer(model, tmp_path):
    _, model_dir, params = model
    path = str(tmp_path / "port.ply")
    tio.save_ply(from_numpy(params, "cpu"), path)
    with open(path, "rb") as a, open(model_dir / "point_cloud" / f"iteration_{ITER}" /
                                     "point_cloud.ply", "rb") as b:
        assert a.read() == b.read()
    loaded = tio.load_ply(path, device="cpu", capacity=200)
    alive = params["alive"]
    assert loaded.capacity == 200 and loaded.num_alive == int(alive.sum())
    for name in ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity"):
        np.testing.assert_array_equal(getattr(loaded, name)[:int(alive.sum())].numpy(),
                                      params[name][alive], err_msg=name)


@pytest.mark.parametrize("with_feature", [False, True])
def test_checkpoint_field_leaves_cross_load(model, tmp_path, with_feature):
    """`alive` is leaf 6 without language features and leaf 7 with them."""
    _, _, params = model
    params = dict(params, language_feature=params["language_feature"]
                  if with_feature else None)
    jpath = str(tmp_path / "jax.npz")
    jio.save_checkpoint(jpath, jax_field(params), (), (), step=11,
                        spatial_lr_scale=2.5, active_sh_degree=2)
    field, step, slr, deg, has_feat = tio.load_field(jpath, device="cpu")
    assert (step, slr, deg, has_feat) == (11, 2.5, 2, with_feature)
    for name in FIELD_NAMES:
        if params.get(name) is None:
            assert getattr(field, name) is None
        else:
            np.testing.assert_array_equal(getattr(field, name).numpy(), params[name],
                                          err_msg=name)
    assert field.alive.dtype == torch.bool
    # and the port's writer is read back by the JAX package
    tpath = str(tmp_path / "port.npz")
    tio.save_field(tpath, field, step=11, spatial_lr_scale=2.5, active_sh_degree=2)
    template = jax_field(dict(params, language_feature=None))
    jfield, *scalars = jio.load_field(tpath, template)
    assert scalars == [11, 2.5, 2, with_feature]
    for name in FIELD_NAMES:
        if params.get(name) is not None:
            np.testing.assert_array_equal(np.asarray(getattr(jfield, name)),
                                          params[name], err_msg=name)
