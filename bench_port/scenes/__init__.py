"""Scene makers: one module per configuration `scene` key, each with
`make(cfg, seed, device) -> Scene`, the inputs that the program and the reference both
take. Nothing here imports the program."""

from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np
import torch


class Scene(NamedTuple):
    leaves: dict          # xyz, f_dc, f_rest, scaling, rotation, opacity,
                          # language_feature, alive: [capacity, ...] on the device
    poses: list           # [(world->camera rotation [3, 3], translation [3])]
    fov_x: float
    fov_y: float
    width: int
    height: int

    def extent(self) -> float:
        """The cameras' bounding radius (NeRF++ normalization, x1.1): the spatial
        learning-rate scale of xyz."""
        centers = np.stack([-r.T @ t for r, t in self.poses])
        return float(np.linalg.norm(centers - centers.mean(axis=0), axis=1).max() * 1.1)


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on `device` for one stream of draws from the run's seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (1 << 63))


def make(cfg: dict, seed: int, device) -> Scene:
    return importlib.import_module(f"bench_port.scenes.{cfg['scene']}").make(
        cfg, seed, device)
