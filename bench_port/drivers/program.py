"""The program's side of a cell: its field, cameras and pipeline built from the
benchmark's inputs, and the reference's leaves read back from a field."""

from __future__ import annotations

import random

import torch

from langsplat_tpu_torch.config import PipelineConfig
from langsplat_tpu_torch.data.cameras import Camera
from langsplat_tpu_torch.models.gaussian_field import GaussianField

#: the reference's leaf name -> the GaussianField attribute
FIELD_ATTR = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
              "scaling": "scaling", "rotation": "rotation", "opacity": "opacity",
              "language_feature": "language_feature", "alive": "alive"}


def field_of(leaves: dict, include_language: bool = True) -> GaussianField:
    return GaussianField(**{attr: (leaves[k] if k != "language_feature" or include_language
                                   else None)
                            for k, attr in FIELD_ATTR.items()})


def leaves_of(field: GaussianField) -> dict:
    return {k: getattr(field, attr) for k, attr in FIELD_ATTR.items()}


def cameras(scene) -> list[Camera]:
    return [Camera(uid=i, colmap_id=i + 1, R=rot.T, T=t, fov_x=scene.fov_x,
                   fov_y=scene.fov_y, image=None, image_name=f"view_{i:03d}",
                   width=scene.width, height=scene.height)
            for i, (rot, t) in enumerate(scene.poses)]


def matrices(cam: Camera, device) -> tuple:
    return tuple(torch.as_tensor(m, dtype=torch.float32).to(device) for m in (
        cam.world_view_transform, cam.full_proj_transform, cam.camera_center))


def pipeline(cfg: dict) -> PipelineConfig:
    return PipelineConfig(tile_size=cfg["tile_size"], **cfg.get("pipeline", {}))


def epoch_order(seed: int, epoch: int, views: int) -> list[int]:
    """The training loop's per-epoch camera order (`train/loop.py schedule_cam`)."""
    order = list(range(views))
    random.Random(seed * 1_000_003 + epoch).shuffle(order)
    return order


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
