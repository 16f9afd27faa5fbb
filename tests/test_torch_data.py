"""PyTorch port, host side: run configs, dataset readers, cameras, the field's
activations and the render-time budget policies against the JAX package."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu import config as jconfig
from langsplat_tpu.data import cameras as jcams
from langsplat_tpu.data import dataset as jds
from langsplat_tpu.models.gaussian_field import GaussianField as JaxField
from langsplat_tpu.train import loop as jloop
from langsplat_tpu_torch import config as tconfig
from langsplat_tpu_torch.data import cameras as tcams
from langsplat_tpu_torch.data import dataset as tds
from langsplat_tpu_torch.models.gaussian_field import FIELD_NAMES, from_numpy
from langsplat_tpu_torch.train import loop as tloop

from tests.test_data import make_colmap_scene
from tests.test_torch_render import field_params

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)


def test_run_config_written_by_jax_loads(tmp_path):
    cfg = jconfig.TrainConfig()
    cfg.model.sh_degree, cfg.model.white_background = 2, True
    cfg.pipeline.tile_size, cfg.pipeline.budget_factor = 8, 3
    cfg.pipeline.interpret = True            # a JAX-only key: ignored by the port
    path = str(tmp_path / "cfg_args.json")
    jconfig.save_config(cfg, path)
    got = tconfig.load_config(path)
    for section in ("model", "pipeline"):
        for name, value in vars(getattr(got, section)).items():
            assert value == getattr(getattr(cfg, section), name), (section, name)
    assert got.model.lf_path == cfg.model.lf_path


def test_colmap_scene_and_cameras_match_jax(tmp_path):
    root = str(tmp_path / "scene")
    make_colmap_scene(root)
    j, t = jds.read_colmap_scene(root), tds.read_colmap_scene(root)
    assert len(t.train_cameras) == len(j.train_cameras) == 3
    for a, b in zip(t.point_cloud, j.point_cloud):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.nerf_normalization["translate"],
                                  j.nerf_normalization["translate"])
    assert t.nerf_normalization["radius"] == j.nerf_normalization["radius"]
    for ti, ji in zip(t.train_cameras, j.train_cameras):
        tc, jc = tcams.load_camera(ti, 1.0, -1, uid=0), jcams.load_camera(ji, 1.0, -1, uid=0)
        for name in ("world_view_transform", "full_proj_transform", "camera_center",
                     "image"):
            np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
        assert (tc.tanfovx, tc.tanfovy, tc.width, tc.height, tc.image_name) == (
            jc.tanfovx, jc.tanfovy, jc.width, jc.height, jc.image_name)
    assert tds.detect_scene_type(root) == "colmap"


def test_blender_scene_matches_jax(tmp_path):
    from PIL import Image
    root = str(tmp_path / "blender")
    os.makedirs(os.path.join(root, "train"))
    frames = []
    rng = np.random.default_rng(2)
    for i in range(2):
        c2w = np.eye(4)
        c2w[:3, 3] = [0, 0, 3 + i]
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": c2w.tolist()})
        arr = (rng.uniform(size=(16, 16, 4)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(root, f"train/r_{i}.png"))
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    j = jds.read_blender_scene(root, white_background=True)
    t = tds.read_blender_scene(root, white_background=True)
    for ti, ji in zip(t.train_cameras, j.train_cameras):
        np.testing.assert_array_equal(ti.R, ji.R)
        np.testing.assert_array_equal(ti.load_image(16, 16), ji.load_image(16, 16))
    assert tds.detect_scene_type(root) == "blender"


@pytest.mark.parametrize("level", [0, 3])
def test_language_feature_matches_jax(tmp_path, level):
    h, w, m = 8, 10, 5
    rng = np.random.default_rng(4)
    np.save(tmp_path / "view0_s.npy", rng.integers(-1, m, (4, h, w)).astype(np.int32))
    np.save(tmp_path / "view0_f.npy", rng.normal(size=(m, 3)).astype(np.float32))
    kw = dict(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3), fov_x=0.8, fov_y=0.8,
              image=None, image_name="view0", width=w, height=h)
    tf, tm = tcams.Camera(**kw).get_language_feature(str(tmp_path), level)
    jf, jm = jcams.Camera(**kw).get_language_feature(str(tmp_path), level)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tm, jm)


def test_field_activations_match_jax():
    params = field_params(seed=3)
    t = from_numpy(params, "cpu")
    j = JaxField(**{k: jnp.asarray(params[k]) for k in FIELD_NAMES})
    for name in ("get_scaling", "get_rotation", "get_opacity", "get_features",
                 "get_language_feature"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(t.get_covariance(0.5).numpy(),
                               np.asarray(j.get_covariance(0.5)), rtol=1e-6, atol=1e-7)
    assert (t.capacity, t.num_alive, t.max_sh_degree) == (
        j.capacity, int(j.num_alive), j.max_sh_degree)

    bare = from_numpy(dict(params, language_feature=None), "cpu")
    with pytest.raises(ValueError):
        bare.get_language_feature
    def seeded():
        return torch.Generator().manual_seed(5)

    lf = bare.with_language_feature(3, init_scale=1e-2, generator=seeded()).language_feature
    assert lf.shape == (bare.capacity, 3) and 0 < float(lf.abs().max()) < 0.1
    torch.testing.assert_close(
        lf, bare.with_language_feature(3, generator=seeded()).language_feature)
    table = np.random.default_rng(0).normal(size=(bare.capacity, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        bare.with_language_feature(3, table=torch.tensor(table)).language_feature.numpy(),
        table)
    assert t.with_language_feature(3) is t


def test_budget_and_tmax_policies_match_jax():
    class Cam:
        width, height = 1000, 600

    for adaptive in (True, False):
        tp = tconfig.PipelineConfig(adaptive_budget=adaptive, budget_factor=2)
        jp = jconfig.PipelineConfig(adaptive_budget=adaptive, budget_factor=2)
        tb, jb = tloop.BudgetPolicy(tp, 50_000), jloop.BudgetPolicy(jp, 50_000)
        steps = [("resize", (50_000, 30_000)), ("grow", (50_000,)),
                 ("grow", (50_000,)), ("resize", (80_000, 200_000)), ("grow", (80_000,))]
        for op, args in steps:
            assert getattr(tb, op)(*args) == getattr(jb, op)(*args)
            assert tb.budget == jb.budget and tb.cap(args[0]) == jb.cap(args[0])
    tt, jt = tloop.TmaxPolicy(tp, [Cam()]), jloop.TmaxPolicy(jp, [Cam()])
    while True:
        grew = tt.grow()
        assert grew == jt.grow() and tt.tmax == jt.tmax
        if not grew:
            break
    assert tt.tmax == tt.grid_cap == jt.grid_cap


def test_prefetcher_schedule_survives_a_load_that_already_finished():
    """`schedule` must return when the load's future is already done as it registers
    its callback (the callback then runs in the calling thread and takes the lock)."""
    import threading
    from concurrent.futures import Future
    from langsplat_tpu_torch.data.prefetch import FeaturePrefetcher

    class Cam:
        image_name = "view"

        def get_language_feature(self, path, level):
            return np.full((3, 4, 5), level, np.float32), np.ones((1, 4, 5), np.float32)

    class FinishedOnSubmit:
        def submit(self, fn, *args):
            fut = Future()
            fut.set_result(fn(*args))
            return fut

        def shutdown(self, **kwargs):
            pass

    pf = FeaturePrefetcher("unused", 2, device=torch.device("cpu"))
    pf._pool.shutdown()
    pf._pool = FinishedOnSubmit()
    worker = threading.Thread(target=pf.schedule, args=(Cam(),), daemon=True)
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    feat, mask = pf.get(Cam())
    assert feat.shape == (3, 4, 5) and float(feat[0, 0, 0]) == 2.0
    assert mask.shape == (1, 4, 5) and not pf._pending
    pf.close()
