"""The LERF-scale box field (`bench.py:44-62`'s Gaussians, with trained-looking SH and
language features): positions x, y in U(-3, 3) and z in U(2.5, 12), log-uniform scales
0.002-0.02, N(0, 1) quaternions, opacities U(0.3, 0.95), `f_dc` N(0, 1), `f_rest`
N(0, 0.2), language features N(0, 1), drawn on the device in one call each.

Every seed does the same work: the geometry (positions, scales, rotations, opacities)
comes from the configuration's `field_seed` and the run's seed permutes the Gaussians'
order and draws their colours and language features. (A geometry drawn from the run's
seed changes the work: whether some Gaussian's tile rect passes the tile cap, which
then doubles, depends on the few nearest, largest Gaussians.) The cameras are a fixed
set drawn from `pose_seed`: positions x, y in U(-1, 1), z in U(-1.5, 0.5), looking
along +z with yaw and pitch within +-`max_angle` rad.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.scenes import Scene, generator


def poses(cfg: dict) -> list[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(cfg["pose_seed"])
    out = []
    for _ in range(cfg["views"]):
        pos = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(-1.5, 0.5)])
        yaw, pitch = rng.uniform(-cfg["max_angle"], cfg["max_angle"], 2)
        cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), math.sin(pitch)
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        w2c = (rx @ ry).T          # rows: the camera's right, down and forward axes
        out.append((w2c, -w2c @ pos))
    return out


def make(cfg: dict, seed: int, device) -> Scene:
    n, cap = cfg["gaussians"], cfg["capacity"]
    if cap != n:
        raise ValueError("the box scene fills its capacity")
    geo = generator(cfg["field_seed"], 1, device)
    gen = generator(seed, 1, device)
    f32 = dict(dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=geo, **f32) * (hi - lo) + lo

    order = torch.randperm(n, generator=gen, device=device)
    xyz = torch.cat([uniform((n, 2), -3.0, 3.0), uniform((n, 1), 2.5, 12.0)], dim=1)
    scaling = uniform((n, 3), math.log(0.002), math.log(0.02))
    rotation = torch.randn((n, 4), generator=geo, **f32)
    opac = uniform((n, 1), 0.3, 0.95)
    k = (cfg["sh_degree"] + 1) ** 2
    leaves = dict(
        xyz=xyz[order], f_dc=torch.randn((n, 1, 3), generator=gen, **f32),
        f_rest=0.2 * torch.randn((n, k - 1, 3), generator=gen, **f32),
        scaling=scaling[order], rotation=rotation[order],
        opacity=torch.log(opac / (1 - opac))[order],
        language_feature=torch.randn((n, cfg["language_channels"]), generator=gen, **f32),
        alive=torch.ones(n, dtype=torch.bool, device=device))
    fov_x = cfg["fov_x"]
    fov_y = 2 * math.atan(math.tan(fov_x / 2) * cfg["height"] / cfg["width"])
    return Scene(leaves, poses(cfg), fov_x, fov_y, cfg["width"], cfg["height"])
