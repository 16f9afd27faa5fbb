"""GaussianField persistence: 3DGS-format PLY files and the JAX package's npz checkpoints.

PyTorch counterpart of `langsplat_tpu/models/field_io.py`. PLY columns are the 3DGS ones
(x,y,z,nx,ny,nz,f_dc_0..2,f_rest_*,opacity,scale_0..2,rot_0..3, all float32, alive
Gaussians only, no language features), and `save_ply` writes the same bytes as the JAX
writer.

A JAX checkpoint (`chkpnt<iter>.npz`) stores the field's leaves as `field_<i>` in
`jax.tree.flatten` order of the GaussianField dataclass, where a None language feature
contributes no leaf: `alive` is `field_6` without features and `field_7` with them
(the `__has_feature` flag says which). `load_field` reads that field group; its writer
counterpart `save_field` stores only the field group and the scalars, which the JAX
package's `load_field` reads back. `save_checkpoint` adds the optimizer group
(`opt_<i>`, the leaves of `trainer.opt_state_leaves`) and the densification statistics
(`stats_<i>`, grad_accum, denom, max_radii2d), so a run resumes from it in full;
`load_checkpoint` reads all three groups back.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from langsplat_tpu_torch.data import ply
from langsplat_tpu_torch.models.gaussian_field import FIELD_NAMES, GaussianField, from_numpy


def save_ply(field: GaussianField, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    alive = field.alive.cpu().numpy()

    def rows(t):
        return t.detach().cpu().numpy()[alive]

    cols: dict[str, np.ndarray] = {}
    xyz = rows(field.xyz)
    n = xyz.shape[0]
    cols["x"], cols["y"], cols["z"] = xyz.T.astype(np.float32)
    for k in ("nx", "ny", "nz"):
        cols[k] = np.zeros(n, np.float32)
    # 3DGS layout: transpose(1,2).flatten -> channel-major over coeffs
    f_dc_flat = rows(field.features_dc).transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_dc_flat.shape[1]):
        cols[f"f_dc_{i}"] = f_dc_flat[:, i].astype(np.float32)
    f_rest_flat = rows(field.features_rest).transpose(0, 2, 1).reshape(n, -1)
    for i in range(f_rest_flat.shape[1]):
        cols[f"f_rest_{i}"] = f_rest_flat[:, i].astype(np.float32)
    cols["opacity"] = rows(field.opacity)[:, 0].astype(np.float32)
    scaling = rows(field.scaling)
    for i in range(3):
        cols[f"scale_{i}"] = scaling[:, i].astype(np.float32)
    rotation = rows(field.rotation)
    for i in range(4):
        cols[f"rot_{i}"] = rotation[:, i].astype(np.float32)
    ply.write_ply(path, cols)


def load_ply(path: str, *, device: str | torch.device,
             capacity: int | None = None) -> GaussianField:
    cols = ply.read_ply(path)
    n = len(cols["x"])
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < {n}")

    def numbered(prefix):
        names = sorted((k for k in cols if k.startswith(prefix)),
                       key=lambda k: int(k.split("_")[-1]))
        return np.stack([cols[k] for k in names], axis=1)

    f_rest = numbered("f_rest_")
    k_rest = f_rest.shape[1] // 3

    def padded(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    rotation = padded(numbered("rot_"))
    rotation[n:, 0] = 1.0
    alive = np.zeros((cap,), bool)
    alive[:n] = True
    return from_numpy({
        "xyz": padded(np.stack([cols["x"], cols["y"], cols["z"]], axis=1)),
        "features_dc": padded(numbered("f_dc_")[:, None, :]),
        "features_rest": padded(f_rest.reshape(n, 3, k_rest).transpose(0, 2, 1)),
        "scaling": padded(numbered("scale_"), -10.0),
        "rotation": rotation,
        "opacity": padded(cols["opacity"][:, None], -10.0),
        "alive": alive,
    }, device)


def _leaf_names(has_feature: bool) -> list[str]:
    return [n for n in FIELD_NAMES if has_feature or n != "language_feature"]


def load_field(path: str, *, device: str | torch.device):
    """Read the field group (and scalars) of a JAX package checkpoint. Returns
    (field, step, spatial_lr_scale, active_sh_degree, has_feature)."""
    with np.load(path, allow_pickle=False) as data:
        has_feature = bool(data["__has_feature"]) if "__has_feature" in data else False
        params = {name: data[f"field_{i}"]
                  for i, name in enumerate(_leaf_names(has_feature))}
        field = from_numpy(params, device)
        return (field, int(data["__step"]), float(data["__spatial_lr_scale"]),
                int(data["__active_sh_degree"]), has_feature)


def save_field(path: str, field: GaussianField, step: int, spatial_lr_scale: float,
               active_sh_degree: int) -> None:
    """Write a checkpoint holding the field group and the scalars (no optimizer or
    densification state), in the layout `load_field` reads."""
    save_checkpoint(path, field, None, None, step, spatial_lr_scale, active_sh_degree)


def save_checkpoint(path: str, field: GaussianField, opt_state: dict | None,
                    stats, step: int, spatial_lr_scale: float,
                    active_sh_degree: int) -> None:
    """Write the training state: the field group, the optimizer group (if
    `opt_state`), the densification-statistics group (if `stats`) and the scalars."""
    from langsplat_tpu_torch.train.densify import STAT_NAMES
    from langsplat_tpu_torch.train.trainer import opt_state_leaves

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    has_feature = field.language_feature is not None
    flat = {f"field_{i}": getattr(field, name).detach().cpu().numpy()
            for i, name in enumerate(_leaf_names(has_feature))}
    if opt_state is not None:
        flat.update({f"opt_{i}": leaf
                     for i, leaf in enumerate(opt_state_leaves(opt_state))})
    if stats is not None:
        flat.update({f"stats_{i}": getattr(stats, name).detach().cpu().numpy()
                     for i, name in enumerate(STAT_NAMES)})
    flat["__step"] = np.int64(step)
    flat["__spatial_lr_scale"] = np.float64(spatial_lr_scale)
    flat["__active_sh_degree"] = np.int64(active_sh_degree)
    flat["__has_feature"] = np.bool_(has_feature)
    np.savez(path, **flat)


def checkpoint_has_state(path: str) -> bool:
    """True if the checkpoint holds optimizer and statistics groups (a full resume is
    possible)."""
    with np.load(path, allow_pickle=False) as data:
        return any(k.startswith("opt_") for k in data.files)


def load_checkpoint(path: str, *, device: str | torch.device):
    """Read the whole training state of a checkpoint written by `save_checkpoint`.
    Returns (field, opt_state, stats, step, spatial_lr_scale, active_sh_degree)."""
    from langsplat_tpu_torch.train.densify import STAT_NAMES, DensifyStats
    from langsplat_tpu_torch.train.trainer import opt_state_from_numpy

    field, step, slr, deg, has_feature = load_field(path, device=device)
    with np.load(path, allow_pickle=False) as data:
        opt_keys = sorted((k for k in data.files if k.startswith("opt_")),
                          key=lambda k: int(k.split("_")[1]))
        opt_state = opt_state_from_numpy([data[k] for k in opt_keys], has_feature,
                                         device)
        stats = DensifyStats(*(torch.as_tensor(data[f"stats_{i}"], device=device)
                               for i in range(len(STAT_NAMES))))
    return field, opt_state, stats, step, slr, deg
