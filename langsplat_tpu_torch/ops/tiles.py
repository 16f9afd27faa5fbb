"""Tile binning: duplicate visible Gaussians per touched tile, order by (tile, depth),
compute per-tile contiguous ranges.

PyTorch counterpart of `langsplat_tpu/ops/tiles.py:251 bin_gaussians`. The output
`InstanceBuffer` equals the JAX package's field for field: the same static `budget`-sized
arrays, the same gaussian-major pre-sort slot order, the same [tile | depth rank] sort
key, the same padding sentinels and drop counters.

`bin_gaussians` and `instance_counts` dispatch by device. CPU tensors take the plain
versions (`bin_gaussians_plain`): the pass mask is a [N, tmax] bool tensor
(`tile_pass_mask`; the JAX package packs the same bits into uint32 words) and the
instances are its `nonzero()` entries, which come out in the same gaussian-major,
rect-position order; the sort key is int64 with the JAX fused uint32 key's bit layout.
That costs six host syncs and ~40 elementwise ops on [N, tmax] tensors a view.

CUDA tensors take the kernels of `csrc/binning.cu` (`bin_gaussians_cuda`), bit-equal to
the plain version on every field, or raise. What bounds binning is device-memory bytes:
~45 B read a Gaussian, the budget-sized outputs written, ~1.5M keys sorted at 1M
Gaussians, ~0.1 ms on an H100. The design keeps it there: a count kernel runs the cull
in registers and scans the counts on the device (the total, num_instances and dropped
never reach the host), a radix sort ranks the Gaussians by depth, an emit kernel runs
the cull again and writes each kept instance's [tile | depth rank] key at its
gaussian-major slot, the radix sort orders only the kept keys (their count read on the
device) over only the key's used bits, and a range pass writes the outputs and their
padding. No host sync, no [N, tmax] intermediate, a fixed number of launches.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from langsplat_tpu_torch.ops import _build
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


def _culled(tile_size: int | None, tmax: int, cull: bool) -> bool:
    """Whether binning runs the tile cull (else each rect's first tmax positions)."""
    return cull and tile_size is not None and tmax <= MAX_CULL_TMAX


def instance_counts(prep: PreprocessOut, *, tile_size: int | None, tmax: int,
                    cull: bool = True,
                    opacities: torch.Tensor | None = None) -> torch.Tensor:
    """Per-Gaussian int32 instance count a bin_gaussians call would produce: on CUDA
    tensors the count kernel that binning runs, else the plain version."""
    kw = dict(tile_size=tile_size, tmax=tmax, cull=cull, opacities=opacities)
    if prep.means2d.device.type == "cuda":
        return instance_counts_cuda(prep, **kw)
    return instance_counts_plain(prep, **kw)


def instance_counts_plain(prep: PreprocessOut, *, tile_size: int | None, tmax: int,
                          cull: bool = True,
                          opacities: torch.Tensor | None = None) -> torch.Tensor:
    """`instance_counts` in plain PyTorch, on any device."""
    if _culled(tile_size, tmax, cull):
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
    1/255 are left out, per `tile_pass_mask`. CUDA tensors take the kernels
    (`bin_gaussians_cuda`), others the plain version; both give the same buffer.
    """
    kw = dict(grid_x=grid_x, grid_y=grid_y, budget=budget,
              max_tiles_per_gaussian=max_tiles_per_gaussian, tile_size=tile_size,
              cull=cull, opacities=opacities)
    if prep.means2d.device.type == "cuda":
        return bin_gaussians_cuda(prep, **kw)
    return bin_gaussians_plain(prep, **kw)


def bin_gaussians_plain(prep: PreprocessOut, *, grid_x: int, grid_y: int, budget: int,
                        max_tiles_per_gaussian: int = 32, tile_size: int | None = None,
                        cull: bool = True,
                        opacities: torch.Tensor | None = None) -> InstanceBuffer:
    """`bin_gaussians` in plain PyTorch, on any device (six host syncs)."""
    n = prep.means2d.shape[0]
    device = prep.means2d.device
    num_tiles = grid_x * grid_y
    tmax = max_tiles_per_gaussian

    w = prep.tiles_max[:, 0] - prep.tiles_min[:, 0]
    h = prep.tiles_max[:, 1] - prep.tiles_min[:, 1]
    full_count = torch.where(prep.visible, w * h, 0).to(torch.int64)
    if _culled(tile_size, tmax, cull):
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


# ---------------------------------------------------------------------------
# The kernels of csrc/binning.cu
# ---------------------------------------------------------------------------

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: n, lam0, tile size, tmax, cull, budget, 64-bit keys
_CULL_ARGS = [_INT, _FLOAT, _FLOAT, _INT, _INT, _INT, _INT]
_COUNT = _build.Kernel("binning.cu", "bin_count", [_PTR] * 7 + _CULL_ARGS + [_PTR] * 6)
_RANK = _build.Kernel("binning.cu", "bin_rank", [_PTR] + [_INT] * 3)
_EMIT = _build.Kernel("binning.cu", "bin_emit",
                      [_PTR] * 6 + _CULL_ARGS + [_PTR, _INT, _INT, _PTR])
_SORT = _build.Kernel("binning.cu", "bin_sort", [_PTR] + [_INT] * 4 + [_PTR] * 2)
_RANGES = _build.Kernel("binning.cu", "bin_ranges", [_PTR] + [_INT] * 6 + [_PTR] * 5)
#: the int32 words of the kernels' scratch for (n, budget, 64-bit keys)
_SCRATCH_WORDS = _build.Kernel("binning.cu", "bin_scratch_words", [_INT] * 3,
                               ctypes.c_longlong, launch=False)
#: the output fields of an InstanceBuffer, in the order of its int32 outputs buffer
_OUT_FIELDS = ("gauss_id", "tile_id", "presort_slot", "tile_start", "gauss_offsets",
               "num_instances", "dropped", "rect_dropped")


def _kernel_inputs(prep: PreprocessOut, opacities: torch.Tensor | None) -> tuple:
    """preprocess's outputs and the opacities as the kernels read them (contiguous; a
    copy only where a caller passed a strided view), checked."""
    device = prep.means2d.device
    n = prep.means2d.shape[0]
    f32, i32 = torch.float32, torch.int32
    ins = [t.contiguous() for t in (prep.means2d, prep.conics, prep.tiles_min,
                                    prep.tiles_max, prep.visible, prep.depths)]
    for name, t, dtype, shape in zip(
            ("means2d", "conics", "tiles_min", "tiles_max", "visible", "depths"), ins,
            (f32, f32, i32, i32, torch.bool, f32), ((n, 2), (n, 3), (n, 2), (n, 2), (n,),
                                                    (n,))):
        _build.check(name, t, dtype, shape, device)
    if opacities is not None:
        opacities = opacities.reshape(-1).contiguous()
        _build.check("opacities", opacities, f32, (n,), device)
    return (*ins, opacities)


def _cull_args(n: int, tile_size: int | None, tmax: int, cull: bool, budget: int = 0,
               key64: bool = False) -> list:
    if tmax < 0:
        raise ValueError(f"max_tiles_per_gaussian must be >= 0, got {tmax}")
    culled = _culled(tile_size, tmax, cull)
    return [n, -math.log(ALPHA_EPS), float(tile_size) if culled else 0.0, tmax, int(culled),
            budget, int(key64)]


def instance_counts_cuda(prep: PreprocessOut, *, tile_size: int | None, tmax: int,
                         cull: bool = True,
                         opacities: torch.Tensor | None = None) -> torch.Tensor:
    """`instance_counts` on the count kernel (one `bin_count` launch, no host sync)."""
    device = prep.means2d.device
    means2d, conics, tmin, tmax_, visible, _, opac = _kernel_inputs(prep, opacities)
    n = means2d.shape[0]
    counts = torch.empty((n,), dtype=torch.int32, device=device)
    _COUNT(device, means2d, conics, tmin, tmax_, visible, opac, None,
           *_cull_args(n, tile_size, tmax, cull), None, counts, None, None, None, None)
    return counts


def bin_gaussians_cuda(prep: PreprocessOut, *, grid_x: int, grid_y: int, budget: int,
                       max_tiles_per_gaussian: int = 32, tile_size: int | None = None,
                       cull: bool = True, opacities: torch.Tensor | None = None,
                       out: InstanceBuffer | None = None) -> InstanceBuffer:
    """`bin_gaussians` on the kernels of csrc/binning.cu (CUDA tensors): `bin_count`,
    `bin_rank`, `bin_emit`, `bin_sort`, `bin_ranges`, one launch each, with no host
    sync. `out` (an InstanceBuffer of int32 tensors of the output shapes) receives the
    result in place. Inputs of other dtypes or shapes raise."""
    device = prep.means2d.device
    if device.type != "cuda":
        raise ValueError(f"bin_gaussians_cuda needs CUDA tensors, got {device}")
    means2d, conics, tmin, tmax_, visible, depths, opac = _kernel_inputs(prep, opacities)
    n = means2d.shape[0]
    tmax = max_tiles_per_gaussian
    num_tiles = grid_x * grid_y
    if budget < 0 or num_tiles < 1:
        raise ValueError(f"budget {budget} and grid {grid_x}x{grid_y} must be positive")
    rank_bits = max(1, (n - 1).bit_length())
    bits = rank_bits + (num_tiles - 1).bit_length()
    if bits > 64:
        raise ValueError(f"a sort key of {bits} bits does not fit 64")
    key64 = bits > 32

    shapes = dict(gauss_id=(budget,), tile_id=(budget,), presort_slot=(budget,),
                  tile_start=(num_tiles + 1,), gauss_offsets=(n + 1,), num_instances=(),
                  dropped=(), rect_dropped=())
    if out is None:   # one allocation, cut into the fields (the counters 0-dim)
        sizes = [budget] * 3 + [num_tiles + 1, n + 1, 1, 1, 1]
        parts = torch.empty((sum(sizes),), dtype=torch.int32, device=device).split(sizes)
        outs = dict(zip(_OUT_FIELDS, [*parts[:5], *(p[0] for p in parts[5:])]))
    else:
        outs = {name: getattr(out, name) for name in _OUT_FIELDS}
        for name in _OUT_FIELDS:
            _build.check(name, outs[name], torch.int32, shapes[name], device)

    scratch = torch.empty((_SCRATCH_WORDS(n, budget, int(key64)),), dtype=torch.int32,
                          device=device)
    args = _cull_args(n, tile_size, tmax, cull, budget, key64)
    _COUNT(device, means2d, conics, tmin, tmax_, visible, opac, depths, *args, scratch,
           None, outs["gauss_offsets"], outs["num_instances"], outs["dropped"],
           outs["rect_dropped"])
    _RANK(device, scratch, n, budget, int(key64))
    _EMIT(device, means2d, conics, tmin, tmax_, visible, opac, *args, scratch, grid_x,
          rank_bits, outs["gauss_offsets"])
    _SORT(device, scratch, n, budget, int(key64), bits, outs["num_instances"],
          outs["presort_slot"])
    _RANGES(device, scratch, n, budget, int(key64), bits, rank_bits, num_tiles,
            outs["num_instances"], outs["tile_id"], outs["gauss_id"], outs["presort_slot"],
            outs["tile_start"])
    return InstanceBuffer(**outs, max_tiles=tmax)
