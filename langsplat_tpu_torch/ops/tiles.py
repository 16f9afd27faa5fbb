"""Tile binning: duplicate visible Gaussians per touched tile, order by (tile, depth),
compute per-tile contiguous ranges.

PyTorch counterpart of `langsplat_tpu/ops/tiles.py:251 bin_gaussians`. The output
`InstanceBuffer` equals the JAX package's field for field: the same static `budget`-sized
arrays, the same gaussian-major pre-sort slot order, the same [tile | depth rank] sort
key, the same padding sentinels and drop counters.

What differs is only how it is built. The JAX package propagates per-Gaussian rows over
the budget axis with scatter+cumsum and keeps the tile-pass mask as uint32 bit words,
because random gathers are slow on a TPU; here the mask is a [N, tmax] bool tensor and
the instances are its `nonzero()` entries, which come out in the same gaussian-major,
rect-position order. The sort key is int64 (torch has little uint32 support) with the
same bit layout as the JAX fused uint32 key.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from langsplat_tpu_torch.ops.projection import PreprocessOut
from langsplat_tpu_torch.ops.rasterize_reference import ALPHA_EPS
from langsplat_tpu_torch.utils import tracing

#: widest per-Gaussian tile cap the culled path supports; beyond it bin_gaussians bins
#: the first tmax positions of the rect unculled (the JAX package's uint32-word limit,
#: kept so that both packages produce the same instances)
MAX_CULL_TMAX = 128


@dataclass(frozen=True)
class InstanceBuffer:
    """Depth-and-tile-sorted Gaussian instances (all static `budget`-sized)."""
    gauss_id: torch.Tensor      # [budget] int32 index into the Gaussian axis (N for padding)
    tile_id: torch.Tensor       # [budget] int32 sorted tile ids (num_tiles for padding)
    tile_start: torch.Tensor    # [num_tiles + 1] int32 range starts into the sorted arrays
    num_instances: torch.Tensor  # [] int32 valid instance count
    dropped: torch.Tensor       # [] int32 instances lost to the budget cap
    rect_dropped: torch.Tensor  # [] int32 tile positions lost to the max_tiles cap
    presort_slot: torch.Tensor  # [budget] int32 compacted pre-sort slot (gaussian-major)
    gauss_offsets: torch.Tensor  # [N + 1] int32 pre-sort slot range per Gaussian
    max_tiles: int = 32         # the stride of presort_slot


def _alpha_threshold(opacities: torch.Tensor | None, device) -> torch.Tensor:
    """-log(ALPHA_EPS) [+ log(opa)] as float32: alpha = opa*exp(-Q) reaches ALPHA_EPS
    only where Q <= this. Computed in float32 like the JAX package, so the cull bits
    agree at the threshold."""
    lam = tracing.upload("binning.threshold", -math.log(ALPHA_EPS), dtype=torch.float32,
                         device=device)
    if opacities is None:
        return lam.reshape(1, 1)
    return (lam + torch.log(torch.clamp_min(opacities.reshape(-1), 1e-12)))[:, None]


def tile_pass_mask(prep: PreprocessOut, *, tile_size: int, tmax: int,
                   opacities: torch.Tensor | None = None) -> torch.Tensor:
    """Per-Gaussian bool mask [N, tmax] over its (clipped) tile rect, row-major:
    position j is True iff tile j can receive alpha >= ALPHA_EPS from this Gaussian.

    The same conservative ellipse-vs-tile test as `langsplat_tpu/ops/tiles.py:118`
    (the minimum of the conic quadratic over the tile's pixel box against
    log(opa / ALPHA_EPS)), in the same float32 operation order. Rects larger than
    `tmax` positions are not culled: their first tmax positions pass, unless the
    opacity alone is below ALPHA_EPS.
    """
    lam = _alpha_threshold(opacities, prep.means2d.device)
    ts = float(tile_size)
    minx = prep.tiles_min[:, 0:1].to(torch.float32)
    miny = prep.tiles_min[:, 1:2].to(torch.float32)
    w = torch.clamp_min(prep.tiles_max[:, 0:1] - prep.tiles_min[:, 0:1], 1)
    h = torch.clamp_min(prep.tiles_max[:, 1:2] - prep.tiles_min[:, 1:2], 1)
    rect = w * h                                              # [N, 1]
    j = torch.arange(tmax, dtype=torch.int32, device=rect.device)[None, :]
    tx = minx + (j % w).to(torch.float32)
    ty = miny + (j // w).to(torch.float32)
    mx = prep.means2d[:, 0:1]
    my = prep.means2d[:, 1:2]
    ca = prep.conics[:, 0:1]
    cb = prep.conics[:, 1:2]
    cc = prep.conics[:, 2:3]
    # pixel-center box of tile (tx, ty), relative to the mean
    x0 = tx * ts - mx
    x1 = x0 + (ts - 1.0)
    y0 = ty * ts - my
    y1 = y0 + (ts - 1.0)
    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    ca_s = torch.clamp_min(ca, 1e-12)
    cc_s = torch.clamp_min(cc, 1e-12)
    qmin = torch.minimum(
        torch.minimum(q(x0, clip(-cb * x0 / cc_s, y0, y1)),
                      q(x1, clip(-cb * x1 / cc_s, y0, y1))),
        torch.minimum(q(clip(-cb * y0 / ca_s, x0, x1), y0),
                      q(clip(-cb * y1 / ca_s, x0, x1), y1)))
    qmin = torch.where(inside, 0.0, qmin)
    visible = prep.visible[:, None]
    passing = (j < rect) & (qmin <= lam) & visible
    # huge rects: no culling, the first tmax positions pass, unless lam < 0 (opacity
    # below ALPHA_EPS: alpha <= opa < eps everywhere since Q >= 0)
    full = (j < torch.clamp_max(rect, tmax)) & visible & (lam >= 0.0)
    return torch.where(rect > tmax, full, passing)


def instance_counts(prep: PreprocessOut, *, tile_size: int | None, tmax: int,
                    cull: bool = True,
                    opacities: torch.Tensor | None = None) -> torch.Tensor:
    """Per-Gaussian int32 instance count a bin_gaussians call would produce."""
    if cull and tile_size is not None and tmax <= MAX_CULL_TMAX:
        mask = tile_pass_mask(prep, tile_size=tile_size, tmax=tmax, opacities=opacities)
        return mask.sum(dim=1, dtype=torch.int32)
    w = prep.tiles_max[:, 0] - prep.tiles_min[:, 0]
    h = prep.tiles_max[:, 1] - prep.tiles_min[:, 1]
    full_count = torch.where(prep.visible, w * h, 0)
    return torch.clamp_max(full_count, tmax)


def bin_gaussians(prep: PreprocessOut, *, grid_x: int, grid_y: int, budget: int,
                  max_tiles_per_gaussian: int = 32, tile_size: int | None = None,
                  cull: bool = True,
                  opacities: torch.Tensor | None = None) -> InstanceBuffer:
    """Build the sorted instance buffer from preprocess output.

    Instances are listed gaussian-major (Gaussian index, then rect position, row-major
    over the clipped rect); the first `budget` of them are kept, sorted by tile and
    then by the Gaussian's depth rank (ties by Gaussian index), and padded to `budget`.
    With `tile_size` given (and cull=True), tiles the ellipse cannot reach at alpha >=
    1/255 are left out, per `tile_pass_mask`.
    """
    n = prep.means2d.shape[0]
    device = prep.means2d.device
    num_tiles = grid_x * grid_y
    tmax = max_tiles_per_gaussian

    w = prep.tiles_max[:, 0] - prep.tiles_min[:, 0]
    h = prep.tiles_max[:, 1] - prep.tiles_min[:, 1]
    full_count = torch.where(prep.visible, w * h, 0).to(torch.int64)
    if cull and tile_size is not None and tmax <= MAX_CULL_TMAX:
        mask = tile_pass_mask(prep, tile_size=tile_size, tmax=tmax, opacities=opacities)
        count = mask.sum(dim=1)
        # culled tiles inside the rect are provably zero-contribution, not dropped; the
        # unexamined tail of huge rects counts as dropped, unless the Gaussian's opacity
        # alone is below ALPHA_EPS (then its whole contribution is provably zero)
        any_alpha = _alpha_threshold(opacities, device)[:, 0] >= 0.0
        rect_dropped = torch.where((full_count > tmax) & any_alpha,
                                   full_count - tmax, 0).sum()
        with tracing.synced("binning.nonzero"):
            gid, pos = mask.nonzero(as_tuple=True)
        offsets = torch.cumsum(count, 0) - count
    else:
        count = torch.clamp_max(full_count, tmax)
        rect_dropped = (full_count - count).sum()
        offsets = torch.cumsum(count, 0) - count
        # two syncs: the output's size and the check that no count is negative
        with tracing.synced("binning.repeat_interleave", 2):
            gid = torch.repeat_interleave(torch.arange(n, device=device), count)
        pos = torch.arange(gid.shape[0], device=device) - offsets[gid]
    total = gid.shape[0]
    kept = min(total, budget)
    gid, pos = gid[:kept], pos[:kept]

    wclip = torch.clamp_min(w, 1).to(torch.int64)[gid]
    tx = prep.tiles_min[gid, 0].to(torch.int64) + pos % wclip
    ty = prep.tiles_min[gid, 1].to(torch.int64) + pos // wclip
    tile = ty * grid_x + tx

    # depth rank: stable sort, so equal depths order by Gaussian index; invisible
    # Gaussians sort last
    depth_keys = torch.where(prep.visible, prep.depths, torch.inf)
    by_depth = torch.sort(depth_keys, stable=True).indices
    rank = torch.empty(n, dtype=torch.int64, device=device)
    rank[by_depth] = torch.arange(n, device=device)
    rank_bits = max(1, (n - 1).bit_length())
    key = (tile << rank_bits) | rank[gid]
    order = torch.sort(key, stable=True).indices   # keys are unique

    def padded(values, fill):
        out = torch.full((budget,), fill, dtype=torch.int32, device=device)
        out[:kept] = values
        return out

    tile_id = padded(tile[order], num_tiles)
    tile_start = torch.searchsorted(
        tile_id, torch.arange(num_tiles + 1, dtype=torch.int32, device=device)
    ).to(torch.int32)
    gauss_offsets = torch.cat([offsets, tracing.upload("binning.total", [total],
                                                       device=device)])
    return InstanceBuffer(
        gauss_id=padded(gid[order], n),
        tile_id=tile_id,
        tile_start=tile_start,
        num_instances=tracing.upload("binning.kept", kept, dtype=torch.int32,
                                     device=device),
        dropped=tracing.upload("binning.dropped", max(total - budget, 0),
                               dtype=torch.int32, device=device),
        rect_dropped=rect_dropped.to(torch.int32),
        presort_slot=padded(order, budget),
        gauss_offsets=gauss_offsets.to(torch.int32),
        max_tiles=tmax,
    )
