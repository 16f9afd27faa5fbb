"""The quality protocol's synthetic room at its final field size.

The geometry is the protocol's (`QualityParams`, `build_gt_geometry`, `make_cameras`,
copied here): a 6x6 floor with a two-tone check and K striped spheres on a ring, drawn
from the protocol's fixed scene seed, with the point counts cut in the GT's own ratio
to the configuration's `floor_pts` + K x `obj_pts`; the GT rule's isotropic scales,
which follow the point density; opacity 0.92; identity rotations. The seed draws
`f_rest` (small, the SH bands a trained field grows) and the language features. The
field sits in the fixed-capacity layout that the protocol's run ends with: `capacity`
slots, the first `gaussians` alive, the rest dead (log-scale and opacity logit -10).
The cameras are the 40 orbit poses at 960x720, focal 900; the train split (llffhold
8) is the configuration's views.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.scenes import Scene, generator

SH_C0 = 0.28209479177387814
PALETTE = np.array([
    [0.85, 0.25, 0.20], [0.20, 0.55, 0.85], [0.95, 0.80, 0.25],
    [0.30, 0.75, 0.35], [0.70, 0.35, 0.80], [0.90, 0.55, 0.20],
], np.float32)


def geometry(cfg: dict):
    """(means [N, 3], colors [N, 3], scales [N]) from the protocol's scene seed."""
    rng = np.random.default_rng(cfg["scene_seed"])
    k = cfg["objects"]
    ang = np.linspace(0, 2 * np.pi, k, endpoint=False) + 0.3
    rad = rng.uniform(0.9, 1.5, k)
    r_obj = rng.uniform(0.28, 0.42, k)
    centers = np.stack([rad * np.cos(ang), rad * np.sin(ang), r_obj + 0.02], axis=1)
    n = cfg["floor_pts"]
    xy = rng.uniform(-3, 3, (n, 2))
    check = (np.floor(xy[:, 0] / 0.5) + np.floor(xy[:, 1] / 0.5)) % 2
    base = np.where(check[:, None] > 0, 0.62, 0.30)
    wash = 0.08 * np.stack([np.sin(2.1 * xy[:, 0]), np.sin(1.7 * xy[:, 1]),
                            np.cos(1.3 * (xy[:, 0] + xy[:, 1]))], axis=1)
    means = [np.concatenate([xy, np.zeros((n, 1))], axis=1)]
    colors = [np.clip(base + wash, 0.02, 0.98)]
    scales = [np.full(n, 6.0 / np.sqrt(n) * 0.8)]
    for i in range(k):
        n = cfg["obj_pts"]
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        stripes = 0.20 * np.sin(9.0 * v[:, 2:3] + i) * np.array([[1, -0.6, 0.3]])
        means.append(centers[i] + r_obj[i] * v)
        colors.append(np.clip(PALETTE[i % len(PALETTE)] + stripes
                              + rng.normal(0, 0.02, (n, 3)), 0.02, 0.98))
        scales.append(np.full(n, 2.2 * r_obj[i] / np.sqrt(n) * 2.2))
    return (np.concatenate(means).astype(np.float32),
            np.concatenate(colors).astype(np.float32),
            np.concatenate(scales).astype(np.float32))


def look_at(pos, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    f = np.asarray(target, np.float64) - pos
    f /= np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r /= np.linalg.norm(r)
    return np.stack([r, np.cross(f, r), f])


def poses(cfg: dict) -> list[tuple[np.ndarray, np.ndarray]]:
    """The orbit's train split: world->camera (rotation, translation)."""
    target = np.array([0.0, 0.0, 0.25])
    out = []
    for i in range(cfg["orbit_cams"]):
        if i % 8 == 0:
            continue
        a = 2 * np.pi * i / cfg["orbit_cams"]
        elev = np.deg2rad(18 + 14 * np.sin(3.1 * a))
        radius = 4.1 + 0.3 * np.cos(2.3 * a)
        pos = target + radius * np.array(
            [np.cos(a) * np.cos(elev), np.sin(a) * np.cos(elev), np.sin(elev)])
        rot = look_at(pos, target)
        out.append((rot, -rot @ pos))
    if len(out) != cfg["views"]:
        raise ValueError(f"the orbit's train split has {len(out)} views, the "
                         f"configuration says {cfg['views']}")
    return out


def make(cfg: dict, seed: int, device) -> Scene:
    means, colors, scales = geometry(cfg)
    n, cap = means.shape[0], cfg["capacity"]
    if n != cfg["gaussians"]:
        raise ValueError(f"{n} points, the configuration says {cfg['gaussians']}")
    gen = generator(seed, 2, device)
    f32 = dict(dtype=torch.float32, device=device)

    def padded(x, fill=0.0):
        x = torch.as_tensor(x, **f32)
        out = torch.full((cap,) + tuple(x.shape[1:]), fill, **f32)
        out[:n] = x
        return out

    k = (cfg["sh_degree"] + 1) ** 2
    rotation = torch.zeros((cap, 4), **f32)
    rotation[:, 0] = 1.0
    log_scale = np.log(scales)[:, None].repeat(3, axis=1)
    logit = math.log(cfg["opacity"] / (1 - cfg["opacity"]))
    leaves = dict(
        xyz=padded(means), f_dc=padded(((colors - 0.5) / SH_C0)[:, None, :]),
        f_rest=cfg["f_rest_std"] * torch.randn((cap, k - 1, 3), generator=gen, **f32),
        scaling=padded(log_scale, -10.0), rotation=rotation,
        opacity=padded(np.full((n, 1), logit, np.float32), -10.0),
        language_feature=torch.randn((cap, cfg["language_channels"]), generator=gen,
                                     **f32),
        alive=torch.arange(cap, device=device) < n)
    w, h, f = cfg["width"], cfg["height"], cfg["focal"]
    return Scene(leaves, poses(cfg), 2 * math.atan(w / (2 * f)), 2 * math.atan(h / (2 * f)),
                 w, h)
