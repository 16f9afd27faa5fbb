"""Scene: load a dataset's cameras and a trained field.

PyTorch-port counterpart of `langsplat_tpu/data/scene.py`, for the render path: it loads
the trained iteration's `point_cloud/iteration_<N>/point_cloud.ply` (the JAX `Scene`
with `load_iteration`) at resolution scale 1. Creating a field from the SfM points,
shuffling, other resolution scales and saving come with the training slice.
"""

from __future__ import annotations

import os

import torch

from langsplat_tpu_torch.config import ModelConfig
from langsplat_tpu_torch.data import dataset as ds
from langsplat_tpu_torch.data.cameras import load_camera
from langsplat_tpu_torch.models import field_io


class Scene:
    def __init__(self, cfg: ModelConfig, *, device: str | torch.device,
                 load_iteration: int = -1):
        self.model_path = cfg.model_path
        if load_iteration == -1:
            load_iteration = max_iteration(os.path.join(self.model_path, "point_cloud"))
        self.loaded_iter = load_iteration
        print(f"Loading trained model at iteration {self.loaded_iter}")

        if ds.detect_scene_type(cfg.source_path) == "colmap":
            info = ds.read_colmap_scene(cfg.source_path, cfg.images, eval_split=cfg.eval)
        else:
            info = ds.read_blender_scene(cfg.source_path, cfg.white_background,
                                         eval_split=cfg.eval)

        self.train_cameras = [load_camera(ci, 1.0, cfg.resolution, uid=i)
                              for i, ci in enumerate(info.train_cameras)]
        self.test_cameras = [load_camera(ci, 1.0, cfg.resolution, uid=i)
                             for i, ci in enumerate(info.test_cameras)]

        self.gaussians = field_io.load_ply(
            os.path.join(self.model_path, "point_cloud",
                         f"iteration_{self.loaded_iter}", "point_cloud.ply"),
            device=device)

    def get_train_cameras(self) -> list:
        return self.train_cameras

    def get_test_cameras(self) -> list:
        return self.test_cameras


def max_iteration(folder: str) -> int:
    """The highest `iteration_<N>` under `folder`."""
    return max(int(name.split("_")[-1]) for name in os.listdir(folder))
