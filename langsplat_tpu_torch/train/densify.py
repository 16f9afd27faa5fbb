"""Adaptive density control under a fixed capacity: clone / split / prune as masked
writes into free slots.

PyTorch counterpart of `langsplat_tpu/train/densify.py`. Gaussians live in fixed
`capacity` tensors with an `alive` mask; clones and splits write their children into
free slots, pruning clears the mask, the caller zeroes the Adam moments of the
`reset_mask` slots, and children that find no free slot are counted in `overflow` so
the caller can grow the capacity. The decisions are those of the JAX package:
  - clone: grad-norm >= threshold and max(scale) <= percent_dense*extent -> 1 copy;
  - split: grad-norm >= threshold and max(scale) >  percent_dense*extent -> 2 children
    sampled from the Gaussian (xyz + R @ (noise * scale)), scales / 1.6, original
    pruned;
  - prune: opacity < min_opacity, or (with the size threshold) screen radius >
    size_threshold or world size > 0.1*extent;
  - children inherit the parent's opacity prune verdict; free slots are taken in index
    order; the statistics restart at zero.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import torch

from langsplat_tpu_torch.core.transforms import quat_to_rotmat
from langsplat_tpu_torch.models.gaussian_field import GaussianField

#: statistic names in the JAX DensifyStats's declaration (and checkpoint leaf) order
STAT_NAMES = ("grad_accum", "denom", "max_radii2d")


@dataclass
class DensifyStats:
    """Densification bookkeeping: accumulated screen-space gradient norms, visibility
    counts and the largest screen radius seen, per slot."""
    grad_accum: torch.Tensor   # [cap]
    denom: torch.Tensor        # [cap]
    max_radii2d: torch.Tensor  # [cap]

    @staticmethod
    def zeros(capacity: int, device: str | torch.device) -> "DensifyStats":
        return DensifyStats(*(torch.zeros((capacity,), dtype=torch.float32,
                                          device=device) for _ in STAT_NAMES))


def update_stats(stats: DensifyStats, screenspace_grad: torch.Tensor,
                 visibility: torch.Tensor, radii: torch.Tensor,
                 image_width: int, image_height: int) -> DensifyStats:
    """Per-iteration accumulation. `screenspace_grad` is dL/d(means2D) in pixels; it is
    scaled by (0.5 W, 0.5 H) into the half-image units the default densify threshold
    (2e-4) is calibrated to (`langsplat_tpu/train/densify.py:51-75` says why)."""
    scale = torch.tensor([0.5 * image_width, 0.5 * image_height], dtype=torch.float32,
                         device=screenspace_grad.device)
    gnorm = torch.linalg.vector_norm(screenspace_grad[:, :2] * scale, dim=-1)
    vis = visibility.to(torch.float32)
    return DensifyStats(
        grad_accum=stats.grad_accum + gnorm * vis,
        denom=stats.denom + vis,
        max_radii2d=torch.maximum(stats.max_radii2d,
                                  torch.where(visibility, radii.to(torch.float32), 0.0)))


class DensifyResult(NamedTuple):
    field: GaussianField
    stats: DensifyStats
    reset_mask: torch.Tensor   # [cap] bool: zero the Adam moments of these slots
    overflow: torch.Tensor     # [] int32: children dropped for lack of capacity
    num_alive: torch.Tensor    # [] int32


def densify_and_prune(field: GaussianField, stats: DensifyStats,
                      generator: torch.Generator, *, extent: float,
                      grad_threshold: float = 0.0002, percent_dense: float = 0.01,
                      min_opacity: float = 0.005, use_size_threshold: bool = False,
                      size_threshold: float = 20.0) -> DensifyResult:
    """`densify_core` with its split noise drawn from `generator` (on the field's
    device)."""
    noise = torch.randn((field.capacity, 2, 3), generator=generator,
                        dtype=field.xyz.dtype, device=field.device)
    return densify_core(field, stats, noise, extent=extent,
                        grad_threshold=grad_threshold, percent_dense=percent_dense,
                        min_opacity=min_opacity, use_size_threshold=use_size_threshold,
                        size_threshold=size_threshold)


def densify_core(field: GaussianField, stats: DensifyStats, noise: torch.Tensor, *,
                 extent: float, grad_threshold: float = 0.0002,
                 percent_dense: float = 0.01, min_opacity: float = 0.005,
                 use_size_threshold: bool = False,
                 size_threshold: float = 20.0) -> DensifyResult:
    """Clone, split and prune with the split samples' standard-normal `noise`
    [cap, 2, 3] given by the caller."""
    cap = field.capacity
    device = field.device
    alive = field.alive
    grads = torch.where(stats.denom > 0, stats.grad_accum / stats.denom, 0.0)
    scales = field.get_scaling
    max_scale = torch.amax(scales, dim=-1)
    opa = field.get_opacity[:, 0]

    hot = alive & (grads >= grad_threshold)
    small = max_scale <= percent_dense * extent
    clone_mask = hot & small
    split_mask = hot & ~small

    prune_pred = opa < min_opacity
    if use_size_threshold:
        prune_pred = (prune_pred | (stats.max_radii2d > size_threshold)
                      | (max_scale > 0.1 * extent))
    prune_orig = alive & (prune_pred | split_mask)

    # children: slot j in {0, 1}; clones emit 1, splits emit 2
    emit = torch.stack([clone_mask | split_mask, split_mask], dim=1)      # [cap, 2]
    scaled = noise * scales[:, None, :]
    R = quat_to_rotmat(field.rotation)                                    # [cap, 3, 3]
    # offsets[c, k, i] = sum_j R[c, i, j] scaled[c, k, j], written out in float32
    offsets = sum(R[:, None, :, j] * scaled[:, :, j:j + 1] for j in range(3))
    is_split = split_mask[:, None, None]
    parent_xyz = field.xyz[:, None, :].expand(cap, 2, 3)
    child_xyz = torch.where(is_split, field.xyz[:, None, :] + offsets, parent_xyz)
    split_scaling = torch.log(scales / (0.8 * 2.0))
    child_scaling = torch.where(is_split, split_scaling[:, None, :].expand(cap, 2, 3),
                                field.scaling[:, None, :].expand(cap, 2, 3))
    child_valid = emit & ~(opa < min_opacity)[:, None]

    # free slots: dead or pruned, taken in index order
    survivors = alive & ~prune_orig
    free = ~survivors
    free_ids = torch.sort((~free).to(torch.int8), stable=True).indices
    free_count = int(free.sum())

    flat_valid = child_valid.reshape(-1)                                  # [cap * 2]
    rank = torch.cumsum(flat_valid.to(torch.int64), 0) - 1
    can_place = flat_valid & (rank < free_count)
    dest = free_ids[torch.clamp(rank, 0, cap - 1)][can_place]
    overflow = (flat_valid & ~can_place).sum().to(torch.int32)
    parent = torch.arange(cap, device=device).repeat_interleave(2)[can_place]

    def place(base, child_values):
        out = base.clone()
        out[dest] = child_values
        return out

    new_alive = survivors.clone()
    new_alive[dest] = True
    new_field = GaussianField(
        xyz=place(field.xyz, child_xyz.reshape(-1, 3)[can_place]),
        features_dc=place(field.features_dc, field.features_dc[parent]),
        features_rest=place(field.features_rest, field.features_rest[parent]),
        scaling=place(field.scaling, child_scaling.reshape(-1, 3)[can_place]),
        rotation=place(field.rotation, field.rotation[parent]),
        opacity=place(field.opacity, field.opacity[parent]),
        language_feature=None if field.language_feature is None else
        place(field.language_feature, field.language_feature[parent]),
        alive=new_alive)
    newly_occupied = torch.zeros((cap,), dtype=torch.bool, device=device)
    newly_occupied[dest] = True
    return DensifyResult(field=new_field, stats=DensifyStats.zeros(cap, device),
                         reset_mask=free | newly_occupied, overflow=overflow,
                         num_alive=new_alive.sum().to(torch.int32))


def reset_opacity(field: GaussianField) -> GaussianField:
    """Clamp opacities to <= 0.01. The caller zeroes the opacity group's Adam moments
    for every slot."""
    clamped = torch.clamp_max(field.get_opacity, 0.01)
    return replace(field, opacity=torch.log(clamped / (1.0 - clamped)))
