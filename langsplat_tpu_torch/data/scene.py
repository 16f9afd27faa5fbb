"""Scene: load a dataset's cameras, and create a field from its point cloud or load a
trained one.

PyTorch-port counterpart of `langsplat_tpu/data/scene.py` at resolution scale 1:
dataset-type dispatch by directory shape, the `input.ply` copy and `cameras.json` dump
on a fresh run, the seeded camera shuffle, the NeRF++ extent, the field created from
the SfM points at `initial_capacity_factor` times their count (or a trained
iteration's `point_cloud/iteration_<N>/point_cloud.ply`; neither with
`create_field=False`, for a caller that loads a checkpoint), and `save`.
"""

from __future__ import annotations

import json
import os
import random
import shutil

import torch

from langsplat_tpu_torch.config import ModelConfig
from langsplat_tpu_torch.data import dataset as ds
from langsplat_tpu_torch.data.cameras import camera_to_json, load_camera
from langsplat_tpu_torch.models import field_io
from langsplat_tpu_torch.models.gaussian_field import GaussianField, create_from_pcd


class Scene:
    def __init__(self, cfg: ModelConfig, *, device: str | torch.device,
                 load_iteration: int | None = None, shuffle: bool = True,
                 initial_capacity_factor: float = 1.5, seed: int = 0,
                 create_field: bool = True):
        self.model_path = cfg.model_path
        self.loaded_iter = None
        if load_iteration is not None:
            if load_iteration == -1:
                load_iteration = max_iteration(os.path.join(self.model_path,
                                                            "point_cloud"))
            self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")

        if ds.detect_scene_type(cfg.source_path) == "colmap":
            info = ds.read_colmap_scene(cfg.source_path, cfg.images, eval_split=cfg.eval)
        else:
            info = ds.read_blender_scene(cfg.source_path, cfg.white_background,
                                         eval_split=cfg.eval)

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(info.ply_path, os.path.join(self.model_path, "input.ply"))
            cam_json = [camera_to_json(i, c)
                        for i, c in enumerate(info.train_cameras + info.test_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        train_infos, test_infos = list(info.train_cameras), list(info.test_cameras)
        if shuffle:
            # seeded (not global-state) shuffle, the same permutation as the JAX
            # package's for the same seed, so a resumed run sees the same order
            shuffler = random.Random(seed)
            shuffler.shuffle(train_infos)
            shuffler.shuffle(test_infos)
        self.cameras_extent = info.nerf_normalization["radius"]

        self.train_cameras = [load_camera(ci, 1.0, cfg.resolution, uid=i)
                              for i, ci in enumerate(train_infos)]
        self.test_cameras = [load_camera(ci, 1.0, cfg.resolution, uid=i)
                             for i, ci in enumerate(test_infos)]

        if self.loaded_iter:
            self.gaussians = field_io.load_ply(
                os.path.join(self.model_path, "point_cloud",
                             f"iteration_{self.loaded_iter}", "point_cloud.ply"),
                device=device)
        elif not create_field:
            self.gaussians = None     # the caller loads a checkpoint: no 3-NN
        else:
            pts, cols, _ = info.point_cloud
            self.gaussians = create_from_pcd(
                pts, cols, sh_degree=cfg.sh_degree, device=device,
                capacity=int(len(pts) * initial_capacity_factor))

    def save(self, iteration: int, field: GaussianField | None = None) -> None:
        field = field if field is not None else self.gaussians
        field_io.save_ply(field, os.path.join(self.model_path, "point_cloud",
                                              f"iteration_{iteration}",
                                              "point_cloud.ply"))

    def get_train_cameras(self) -> list:
        return self.train_cameras

    def get_test_cameras(self) -> list:
        return self.test_cameras


def max_iteration(folder: str) -> int:
    """The highest `iteration_<N>` under `folder`."""
    return max(int(name.split("_")[-1]) for name in os.listdir(folder))
