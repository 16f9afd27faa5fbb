"""Tile blend, forward and backward: the CUDA kernels `csrc/blend_fwd.cu` and
`csrc/blend_bwd.cu`, their wrappers, their plain PyTorch versions, and the
`torch.autograd.Function` that joins them.

Port of `langsplat_tpu/ops/rasterize_pallas.py`: the forward blend `_fwd_kernel` (`:597`),
the backward `_bwd_kernel` (`:746`) with the packing gather's segment-sum backward
(`segsum.py`), and the output contract of `rasterize_pallas` (`:1247-1288`): `render`
with `bg` added to RGB only, `final_transmittance`, and `language_feature_image`;
gradients of means2d (through `means2d_override`, the screen-space tap), conics,
opacities, colors and features; `grad_mode` "full" or "feature".

Only the semantics cross over. The TPU path packs every instance's attributes into a
128-lane-aligned buffer (`pack_instances`), fuses several tiles per grid step (`NMEMB`,
`GROUP_SORT`, `_build_sched`) and runs the transmittance as an MXU cumsum of logs; none
of that is needed here. The kernels gather each tile's instances straight from the
per-Gaussian arrays. The backward writes each instance's gradient sums into the
instance's pre-sort slot, and `segsum.segment_sum` reduces them per Gaussian, which is
the JAX packing-gather backward (`_gather_attrs_bwd`, `:216`) without the sort.

Dispatch is by device only: tensors on the CPU go to the plain versions, tensors on a
CUDA device go to the kernels, and anything the kernels do not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from langsplat_tpu_torch.ops import _build
from langsplat_tpu_torch.ops.projection import PreprocessOut
from langsplat_tpu_torch.ops.segsum import segment_sum
from langsplat_tpu_torch.ops.rasterize_reference import ALPHA_EPS, ALPHA_MAX, TERM_EPS
from langsplat_tpu_torch.ops.tiles import InstanceBuffer

#: the kernel's tile edge (one 256-thread block per 16x16 tile)
KERNEL_TILE = 16
#: most language-feature channels the kernel is instantiated for
MAX_FEATURES = 8

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_BLEND_FWD = _build.Kernel("blend_fwd.cu", "blend_fwd",
                           [_PTR] * 9 + [_INT] * 5 + [_PTR] * 2)
_BLEND_BWD = _build.Kernel("blend_bwd.cu", "blend_bwd",
                           [_PTR] * 13 + [_INT] * 7 + [_PTR] * 2)
#: gradient rows of the backward's per-instance output, in order (then the features)
GRAD_ROWS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "opacity",
             "red", "green", "blue")


def _grid(image_height: int, image_width: int, tile_size: int) -> tuple[int, int]:
    return -(-image_width // tile_size), -(-image_height // tile_size)


def _pixel_grid(image_height, image_width, tile_size, device):
    """Per-tile pixel coordinates [NT, P] (pixel p of tile t at row-major offset p),
    and which of them lie inside the image."""
    ts = tile_size
    grid_x, grid_y = _grid(image_height, image_width, ts)
    tiles = torch.arange(grid_x * grid_y, device=device)
    lp = torch.arange(ts * ts, device=device)
    px = ((tiles % grid_x) * ts)[:, None] + lp % ts
    py = ((tiles // grid_x) * ts)[:, None] + lp // ts
    return px, py, (px < image_width) & (py < image_height)


def _to_image(x, image_height, image_width, tile_size):
    """[NT, C, P] per-tile values -> [C, H, W] image."""
    ts = tile_size
    grid_x, grid_y = _grid(image_height, image_width, ts)
    c = x.shape[1]
    img = x.reshape(grid_y, grid_x, c, ts, ts).permute(2, 0, 3, 1, 4)
    return img.reshape(c, grid_y * ts, grid_x * ts)[:, :image_height, :image_width]


def _to_tiles(img, tile_size):
    """[C, H, W] image -> [NT, C, P] per-tile values, zero past the image edge."""
    ts = tile_size
    c, h, w = img.shape
    grid_x, grid_y = _grid(h, w, ts)
    img = torch.nn.functional.pad(img, (0, grid_x * ts - w, 0, grid_y * ts - h))
    img = img.reshape(c, grid_y, ts, grid_x, ts).permute(1, 3, 0, 2, 4)
    return img.reshape(grid_y * grid_x, c, ts * ts)


def _instance_alpha(means2d, conics, opa, gid, fx, fy):
    """The falloff of instance `gid` [NT] at every pixel of its tile: (dx, dy, power,
    exp(min(power, 0)), opacity * that, alpha clamped at ALPHA_MAX), each [NT, P]."""
    m, co, o = means2d[gid], conics[gid], opa[gid]
    dx = fx - m[:, 0:1]
    dy = fy - m[:, 1:2]
    power = (-0.5 * (co[:, 0:1] * dx * dx + co[:, 2:3] * dy * dy)
             - co[:, 1:2] * dx * dy)
    gexp = torch.exp(torch.clamp_max(power, 0.0))
    raw = o[:, None] * gexp
    return dx, dy, power, gexp, raw, torch.clamp_max(raw, ALPHA_MAX)


def _regions_hit(hit, tile_size):
    """[NT, P] per-pixel flags (P row-major over a tile) -> [NT, regions]: whether any
    pixel of each warp region (`REGION_W` x `REGION_H`, numbered row-major) is set."""
    nt = hit.shape[0]
    nx, ny = tile_size // REGION_W, tile_size // REGION_H
    return hit.reshape(nt, ny, REGION_H, nx, REGION_W).any(dim=4).any(dim=2).reshape(
        nt, nx * ny)


def _blend_plain(means2d, conics, opacities, visible, colors, features, gauss_id,
                 tile_start, bg, *, image_height, image_width, tile_size, regions=False):
    """The kernel's arithmetic in plain PyTorch, all tiles at once, one instance depth
    step at a time (memory stays O(image + budget) whatever the instance count).

    Returns (image [3+F, H, W], final T [H, W], evaluated [H, W], blended [H, W],
    blended_in [budget, regions] or None): `evaluated` and `blended` count, per pixel,
    the instances evaluated before the pixel ended (the ending one included) and the
    instances blended into it; with `regions`, `blended_in` flags the warp regions of
    its tile each instance was blended into.
    """
    device = means2d.device
    attrs = colors if features is None else torch.cat([colors, features], dim=1)
    opa = torch.where(visible, opacities, 0.0)
    starts = tile_start[:-1].to(torch.int64)
    counts = (tile_start[1:] - tile_start[:-1]).to(torch.int64)
    px, py, inside = _pixel_grid(image_height, image_width, tile_size, device)
    fx, fy = px.to(torch.float32), py.to(torch.float32)
    num_tiles = px.shape[0]

    T = torch.ones(px.shape, dtype=torch.float32, device=device)
    acc = torch.zeros((num_tiles, attrs.shape[1]) + px.shape[1:], dtype=torch.float32,
                      device=device)
    done = ~inside
    evaluated = torch.zeros(px.shape, dtype=torch.int64, device=device)
    blended = torch.zeros(px.shape, dtype=torch.int64, device=device)
    blended_in = None
    if regions:
        blended_in = torch.zeros((gauss_id.shape[0], (tile_size // REGION_W)
                                  * (tile_size // REGION_H)), dtype=torch.bool,
                                 device=device)
    depth = int(counts.max()) if num_tiles else 0
    last = max(gauss_id.shape[0] - 1, 0)
    for k in range(depth):
        if k % 32 == 0 and bool(done.all()):
            break
        live = (k < counts)[:, None] & ~done                   # [NT, P]
        idx = torch.clamp(starts + k, max=last)
        gid = gauss_id[idx].to(torch.int64)
        gid = torch.where(k < counts, gid, 0)
        _, _, power, _, _, alpha = _instance_alpha(means2d, conics, opa, gid, fx, fy)
        ok = live & (power <= 0.0) & (alpha >= ALPHA_EPS)
        test_t = T * (1.0 - alpha)
        term = ok & (test_t < TERM_EPS)
        blend = ok & ~term
        w = torch.where(blend, alpha * T, 0.0)
        acc = acc + w[:, None, :] * attrs[gid][:, :, None]
        T = torch.where(blend, test_t, T)
        evaluated += live
        blended += blend
        done = done | term
        if regions:
            has = k < counts
            blended_in[idx[has]] = _regions_hit(blend, tile_size)[has]

    acc = torch.cat([acc[:, :3] + T[:, None, :] * bg[None, :, None], acc[:, 3:]], dim=1)
    size = dict(image_height=image_height, image_width=image_width, tile_size=tile_size)
    return (_to_image(acc, **size), _to_image(T[:, None], **size)[0],
            _to_image(evaluated[:, None], **size)[0],
            _to_image(blended[:, None], **size)[0], blended_in)


def blend_forward_plain(means2d, conics, opacities, visible, colors, features, gauss_id,
                        tile_start, bg, *, image_height, image_width, tile_size):
    """Plain PyTorch version of `blend_forward` (same arguments and results)."""
    image, t_final, _, _, _ = _blend_plain(
        means2d, conics, opacities, visible, colors, features, gauss_id, tile_start, bg,
        image_height=image_height, image_width=image_width, tile_size=tile_size)
    return image, t_final


def blend_pairs(means2d, conics, opacities, visible, colors, features, gauss_id,
                tile_start, bg, *, image_height, image_width,
                tile_size) -> tuple[int, int, torch.Tensor]:
    """(instance, pixel) pairs the blend evaluates before each pixel ends, the pairs it
    blends (the work a kernel has to do), and [budget, regions] bool: the warp regions
    of its tile each instance is blended into; for these inputs, from the plain
    version."""
    _, _, evaluated, blended, blended_in = _blend_plain(
        means2d, conics, opacities, visible, colors, features, gauss_id, tile_start, bg,
        image_height=image_height, image_width=image_width, tile_size=tile_size,
        regions=True)
    return int(evaluated.sum()), int(blended.sum()), blended_in


# ---------------------------------------------------------------------------
# The blend kernels' cull, in plain PyTorch
# ---------------------------------------------------------------------------

#: the blend kernels' warp regions: warp w of a tile's 256 threads takes columns
#: (w % 2) * 8 .. + 7 and rows (w // 2) * 4 .. + 3 of the tile
REGION_W, REGION_H = 8, 4
# csrc/blend_common.cuh's cull constants: -ln(1/255); lambda's margin (absolute,
# relative); the factor 1 - 8e-5 ac / det on the box's minimum; the overflow guard
_LN_INV_ALPHA_EPS = 5.5412636
_CULL_ABS, _CULL_LAM_REL, _CULL_REL, _CULL_MAG = 1e-4, 1e-5, 8e-5, 1e30


def _box_keep(px0, px1, py0, py1, mx, my, a, b, c, f, lam_m):
    """csrc/blend_common.cuh box_keep, elementwise: False only where the pixels px0..px1
    x py0..py1 provably receive alpha < 1/255."""
    x0, x1 = px0.to(torch.float32) - mx, px1.to(torch.float32) - mx
    y0, y1 = py0.to(torch.float32) - my, py1.to(torch.float32) - my
    s2 = (x0 * x0 + x1 * x1) + (y0 * y0 + y1 * y1)
    mag = ((a + b.abs()) + c) * s2

    def q(dx, dy):
        return 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy

    def clamp(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)
    qmin = torch.minimum(
        torch.minimum(q(x0, clamp(-b * x0 / c, y0, y1)), q(x1, clamp(-b * x1 / c, y0, y1))),
        torch.minimum(q(clamp(-b * y0 / a, x0, x1), y0), q(clamp(-b * y1 / a, x0, x1), y1)))
    qmin = torch.where(inside, 0.0, qmin)
    return ~(mag < _CULL_MAG) | ~(qmin * f > lam_m)


def _cull_terms(means2d, conics, opacities, visible, gid):
    """Per Gaussian gid: the arguments of `_box_keep` after the pixel box, and whether
    the test can be trusted (csrc/blend_common.cuh cull_terms)."""
    f32 = torch.float32
    mx, my = means2d[gid, 0], means2d[gid, 1]
    a, b, c = conics[gid, 0], conics[gid, 1], conics[gid, 2]
    opa = torch.where(visible, opacities, 0.0)[gid]
    det = a * c - b * b
    f = 1.0 - torch.tensor(_CULL_REL, dtype=f32) * ((a * c) / det)
    trusted = ((opa > 0.0) & (opa <= torch.finfo(f32).max) & (a > 0.0) & (c > 0.0)
               & (det > 0.0) & (f > 0.5))
    lam = torch.log(opa) + torch.tensor(_LN_INV_ALPHA_EPS, dtype=f32)
    lam_m = lam + (torch.tensor(_CULL_ABS, dtype=f32)
                   + torch.tensor(_CULL_LAM_REL, dtype=f32) * lam.abs())
    return (mx, my, a, b, c, f, lam_m), trusted


def cull_box_keep(means2d, conics, opacities, visible, gid, px0, py0, box_w, box_h):
    """The blend kernels' cull test (csrc/blend_common.cuh box_keep, which the forward
    and the backward kernel both call) of Gaussian gid against the pixel box px0 ..
    px0 + box_w - 1 x py0 .. py0 + box_h - 1, elementwise over gid, px0, py0 (int64):
    False only where every pixel of the box provably receives alpha < 1/255."""
    terms, trusted = _cull_terms(means2d, conics, opacities, visible, gid)
    return ~trusted | _box_keep(px0, px0 + box_w - 1, py0, py0 + box_h - 1, *terms)


def warp_region_keep(means2d, conics, opacities, visible, gauss_id, tile_id, *, grid_x,
                     tile_size=KERNEL_TILE) -> torch.Tensor:
    """The cull of both blend kernels, forward and backward (csrc/blend_common.cuh
    stage_batch, which both call), in plain PyTorch with the same float32 arithmetic and
    margins:
    [instances, regions] bool, True where the kernels evaluate instance i in that warp
    region of its tile tile_id[i] (the tile's box is tested first); False for padding
    instances. Only the tests and chip_smoke.py use it."""
    valid = gauss_id < means2d.shape[0]
    gid = torch.where(valid, gauss_id, 0).to(torch.int64)
    tile = torch.where(valid, tile_id, 0).to(torch.int64)
    terms, trusted = _cull_terms(means2d, conics, opacities, visible, gid)
    tx0 = (tile % grid_x) * tile_size
    ty0 = (tile // grid_x) * tile_size
    keep_tile = _box_keep(tx0, tx0 + tile_size - 1, ty0, ty0 + tile_size - 1, *terms)
    nx = tile_size // REGION_W
    kept = torch.stack([
        _box_keep(rx0, rx0 + REGION_W - 1, ry0, ry0 + REGION_H - 1, *terms)
        for rx0, ry0 in ((tx0 + (w % nx) * REGION_W, ty0 + (w // nx) * REGION_H)
                         for w in range(nx * (tile_size // REGION_H)))], dim=1)
    kept = (kept & keep_tile[:, None]) | ~trusted[:, None]
    return kept & valid[:, None]


def _check_blend_inputs(kernel, means2d, conics, opacities, visible, colors, features,
                        gauss_id, tile_start, image_height, image_width, tile_size):
    """Raise on inputs the blend kernels do not take; returns (num_feat, grid_x,
    num_tiles)."""
    device = means2d.device
    if device.type != "cuda":
        raise ValueError(f"{kernel} needs CUDA tensors, got {device}")
    if tile_size != KERNEL_TILE:
        raise ValueError(f"the blend kernels take tile_size {KERNEL_TILE}, got {tile_size}")
    n = means2d.shape[0]
    num_feat = 0 if features is None else features.shape[1]
    if num_feat > MAX_FEATURES:
        raise ValueError(f"the blend kernels take at most {MAX_FEATURES} feature "
                         f"channels, got {num_feat}")
    grid_x, grid_y = _grid(image_height, image_width, tile_size)
    num_tiles = grid_x * grid_y
    f32 = torch.float32
    _build.check("means2d", means2d, f32, (n, 2), device)
    _build.check("conics", conics, f32, (n, 3), device)
    _build.check("opacities", opacities, f32, (n,), device)
    _build.check("visible", visible, torch.bool, (n,), device)
    _build.check("colors", colors, f32, (n, 3), device)
    if features is not None:
        _build.check("features", features, f32, (n, num_feat), device)
    _build.check("gauss_id", gauss_id, torch.int32, (gauss_id.shape[0],), device)
    _build.check("tile_start", tile_start, torch.int32, (num_tiles + 1,), device)
    return num_feat, grid_x, num_tiles


def blend_forward_cuda(means2d, conics, opacities, visible, colors, features, gauss_id,
                       tile_start, bg, *, image_height, image_width, tile_size, out=None):
    """Launch the blend kernel on the tensors' CUDA device and current stream. `out`,
    if given, is the (image, t_final) pair to write into."""
    device = means2d.device
    num_feat, grid_x, num_tiles = _check_blend_inputs(
        "blend_forward_cuda", means2d, conics, opacities, visible, colors, features,
        gauss_id, tile_start, image_height, image_width, tile_size)
    f32 = torch.float32
    _build.check("bg", bg, f32, (3,), device)
    shape = (3 + num_feat, image_height, image_width)
    if out is None:
        image = torch.empty(shape, dtype=f32, device=device)
        t_final = torch.empty(shape[1:], dtype=f32, device=device)
    else:
        image, t_final = out
        _build.check("out image", image, f32, shape, device)
        _build.check("out t_final", t_final, f32, shape[1:], device)
    _BLEND_FWD(device, means2d, conics, opacities, visible, colors, features, gauss_id,
               tile_start, bg, num_feat, image_height, image_width, grid_x, num_tiles,
               image, t_final)
    return image, t_final


def blend_forward(means2d, conics, opacities, visible, colors, features, gauss_id,
                  tile_start, bg, *, image_height, image_width, tile_size):
    """Blend each tile's depth-sorted instances into (image [3+F, H, W] with `bg` added
    to RGB, final transmittance [H, W]). CPU tensors take the plain version; CUDA
    tensors take the kernel."""
    fn = blend_forward_cuda if means2d.device.type == "cuda" else blend_forward_plain
    return fn(means2d, conics, opacities, visible, colors, features, gauss_id,
              tile_start, bg, image_height=image_height, image_width=image_width,
              tile_size=tile_size)


def blend_args(prep: PreprocessOut, inst: InstanceBuffer, opacities: torch.Tensor,
               features: torch.Tensor | None, bg: torch.Tensor) -> tuple:
    """The positional arguments of `blend_forward` for one render, made contiguous."""
    return tuple(None if t is None else t.contiguous() for t in (
        prep.means2d, prep.conics, opacities, prep.visible, prep.colors, features,
        inst.gauss_id, inst.tile_start, bg))




# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def grad_rows(num_feat: int, grad_mode: str) -> int:
    """Rows of the backward's per-instance output: GRAD_ROWS then the features, or only
    the features in grad_mode "feature"."""
    if grad_mode not in ("full", "feature"):
        raise ValueError(f"grad_mode must be 'full' or 'feature', got {grad_mode}")
    if grad_mode == "feature":
        if num_feat == 0:
            raise ValueError("grad_mode='feature' requires language feature channels")
        return num_feat
    return len(GRAD_ROWS) + num_feat


def _blend_backward_plain(means2d, conics, opacities, visible, colors, features, gauss_id,
                          tile_start, presort_slot, g_image, g_tfinal, total, t_final, *,
                          grad_mode, image_height, image_width, tile_size):
    """The backward kernel's arithmetic in plain PyTorch: the forward replayed front to
    back, all tiles at once, one instance depth step at a time (memory stays
    O(image + budget)). Returns (d_pre [R, budget], replayed final T [H, W])."""
    device = means2d.device
    num_feat = 0 if features is None else features.shape[1]
    rows = grad_rows(num_feat, grad_mode)
    feature_only = grad_mode == "feature"
    budget = gauss_id.shape[0]
    attrs = colors if features is None else torch.cat([colors, features], dim=1)
    opa = torch.where(visible, opacities, 0.0)
    starts = tile_start[:-1].to(torch.int64)
    counts = (tile_start[1:] - tile_start[:-1]).to(torch.int64)
    px, py, inside = _pixel_grid(image_height, image_width, tile_size, device)
    fx, fy = px.to(torch.float32), py.to(torch.float32)
    num_tiles = px.shape[0]

    g = _to_tiles(g_image, tile_size)                          # [NT, C, P]
    tot = _to_tiles(total[None], tile_size)[:, 0]               # [NT, P]
    tail = _to_tiles((g_tfinal * t_final)[None], tile_size)[:, 0]
    T = torch.ones(px.shape, dtype=torch.float32, device=device)
    prefix = torch.zeros(px.shape, dtype=torch.float32, device=device)
    done = ~inside
    d_pre = torch.zeros((rows, budget), dtype=torch.float32, device=device)
    depth = int(counts.max()) if num_tiles else 0
    last = max(budget - 1, 0)
    for k in range(depth):
        if k % 32 == 0 and bool(done.all()):
            break
        has = k < counts
        idx = torch.clamp(starts + k, max=last)
        gid = torch.where(has, gauss_id[idx].to(torch.int64), 0)
        dx, dy, power, gexp, raw, alpha = _instance_alpha(means2d, conics, opa, gid,
                                                          fx, fy)
        ok = has[:, None] & ~done & (power <= 0.0) & (alpha >= ALPHA_EPS)
        test_t = T * (1.0 - alpha)
        term = ok & (test_t < TERM_EPS)
        blend = ok & ~term
        w = torch.where(blend, alpha * T, 0.0)
        if feature_only:
            per_pixel = g[:, 3:] * w[:, None, :]                 # [NT, F, P]
        else:
            gdot = (g * attrs[gid][:, :, None]).sum(dim=1)      # [NT, P]
            prefix = prefix + w * gdot
            suffix = (tot - prefix) + tail
            dalpha = torch.where(blend, T * gdot - suffix / (1.0 - alpha), 0.0)
            dag = torch.where(raw < ALPHA_MAX, dalpha, 0.0)
            dpower = dag * alpha
            co = conics[gid]
            a, b, c = co[:, 0:1], co[:, 1:2], co[:, 2:3]
            per_pixel = torch.cat([
                torch.stack([dpower * (a * dx + b * dy), dpower * (c * dy + b * dx),
                             -0.5 * dpower * dx * dx, -dpower * dx * dy,
                             -0.5 * dpower * dy * dy, dag * gexp], dim=1),
                g * w[:, None, :]], dim=1)                      # [NT, R, P]
        slot = presort_slot[idx].to(torch.int64)
        valid = has & (slot < budget)
        d_pre[:, slot[valid]] = per_pixel.sum(dim=2)[valid].T
        T = torch.where(blend, test_t, T)
        done = done | term
    t_replay = _to_image(T[:, None], image_height, image_width, tile_size)[0]
    return d_pre, t_replay


def blend_backward_plain(*args, grad_mode, image_height, image_width, tile_size,
                         return_t=False):
    """Plain PyTorch version of `blend_backward` (same arguments and results)."""
    d_pre, t_replay = _blend_backward_plain(
        *args, grad_mode=grad_mode, image_height=image_height, image_width=image_width,
        tile_size=tile_size)
    return (d_pre, t_replay) if return_t else d_pre


def blend_backward_cuda(means2d, conics, opacities, visible, colors, features, gauss_id,
                        tile_start, presort_slot, g_image, g_tfinal, total, t_final, *,
                        grad_mode, image_height, image_width, tile_size, return_t=False,
                        out=None):
    """Launch the blend backward kernel on the tensors' CUDA device and current
    stream. The output is zeroed here, before the launch: instances a tile never
    reached are not written by the kernel. `out`, if given, is the (d_pre, t_replay)
    pair to write into (t_replay None unless return_t)."""
    device = means2d.device
    num_feat, grid_x, num_tiles = _check_blend_inputs(
        "blend_backward_cuda", means2d, conics, opacities, visible, colors, features,
        gauss_id, tile_start, image_height, image_width, tile_size)
    rows = grad_rows(num_feat, grad_mode)
    budget = gauss_id.shape[0]
    f32 = torch.float32
    hw = (image_height, image_width)
    _build.check("presort_slot", presort_slot, torch.int32, (budget,), device)
    _build.check("g_image", g_image, f32, (3 + num_feat,) + hw, device)
    _build.check("g_tfinal", g_tfinal, f32, hw, device)
    _build.check("total", total, f32, hw, device)
    _build.check("t_final", t_final, f32, hw, device)
    if out is None:
        d_pre = torch.zeros((rows, budget), dtype=f32, device=device)
        t_replay = torch.empty(hw, dtype=f32, device=device) if return_t else None
    else:
        d_pre, t_replay = out
        _build.check("out d_pre", d_pre, f32, (rows, budget), device)
        if (t_replay is not None) != return_t:
            raise ValueError("out's t_replay must be given exactly when return_t is set")
        if return_t:
            _build.check("out t_replay", t_replay, f32, hw, device)
        d_pre.zero_()
    _BLEND_BWD(device, means2d, conics, opacities, visible, colors, features, gauss_id,
               tile_start, presort_slot, g_image, g_tfinal, total, t_final, num_feat,
               int(grad_mode == "feature"), image_height, image_width, grid_x, num_tiles,
               budget, d_pre, t_replay)
    return (d_pre, t_replay) if return_t else d_pre


def blend_backward(means2d, conics, opacities, visible, colors, features, gauss_id,
                   tile_start, presort_slot, g_image, g_tfinal, total, t_final, *,
                   grad_mode, image_height, image_width, tile_size, return_t=False):
    """Per-instance gradient sums of one blend: d_pre [R, budget], column
    presort_slot[i] for instance i (rows GRAD_ROWS then the features, or only the
    features in grad_mode "feature"), from the image gradient g_image [3+F, H, W], the
    final-transmittance gradient g_tfinal [H, W] (the background's share included),
    total = sum_ch g_ch out_ch [H, W] (out without the background) and the forward's
    t_final. With return_t, also the replayed final transmittance. CPU tensors take the
    plain version; CUDA tensors take the kernel."""
    fn = blend_backward_cuda if means2d.device.type == "cuda" else blend_backward_plain
    return fn(means2d, conics, opacities, visible, colors, features, gauss_id,
              tile_start, presort_slot, g_image, g_tfinal, total, t_final,
              grad_mode=grad_mode, image_height=image_height, image_width=image_width,
              tile_size=tile_size, return_t=return_t)


def backward_residuals(image, t_final, bg, g_image, g_t):
    """(g_tfinal, total) for `blend_backward` from the forward's outputs (`image` with
    the background added to RGB) and their gradients. The background term T * bg is
    added after the blend, so its gradient joins dL/dT_final and it leaves Total."""
    g_bg = (g_image[:3] * bg[:, None, None]).sum(dim=0)
    total = (g_image * image).sum(dim=0) - g_bg * t_final
    return (g_t + g_bg).contiguous(), total.contiguous()


class _Blend(torch.autograd.Function):
    """Blend forward (K1) and backward (K2 + the per-Gaussian segment sum K3)."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, colors, features, visible, gauss_id,
                tile_start, presort_slot, gauss_offsets, bg, options):
        image, t_final = blend_forward(
            means2d, conics, opacities, visible, colors, features, gauss_id, tile_start,
            bg, **options["size"])
        ctx.options = options
        ctx.save_for_backward(means2d, conics, opacities, colors, features, visible,
                              gauss_id, tile_start, presort_slot, gauss_offsets, bg,
                              image, t_final)
        return image, t_final

    @staticmethod
    def backward(ctx, g_image, g_t):
        (means2d, conics, opacities, colors, features, visible, gauss_id, tile_start,
         presort_slot, gauss_offsets, bg, image, t_final) = ctx.saved_tensors
        grad_mode = ctx.options["grad_mode"]
        g_tfinal, total = backward_residuals(image, t_final, bg, g_image.contiguous(),
                                             g_t)
        d_pre = blend_backward(
            means2d, conics, opacities, visible, colors, features, gauss_id, tile_start,
            presort_slot, g_image.contiguous(), g_tfinal, total, t_final,
            grad_mode=grad_mode, **ctx.options["size"])
        return reduce_instance_grads(d_pre, gauss_offsets, visible, features is not None,
                                     grad_mode) + (None,) * 7


def reduce_instance_grads(d_pre, gauss_offsets, visible, has_features: bool,
                          grad_mode: str) -> tuple:
    """Per-Gaussian gradients (means2d, conics, opacities, colors, features; None for
    what grad_mode leaves out) from the per-instance gradient rows d_pre [R, budget],
    column presort_slot[i] for instance i: each Gaussian's slots
    gauss_offsets[g] .. gauss_offsets[g+1] reduced in slot order by `segment_sum` (the
    segment-sum kernel on the card), so the sums do not depend on scheduling."""
    budget = d_pre.shape[1]
    n = visible.shape[0]
    ends = torch.clamp(gauss_offsets, 0, budget).to(torch.int32).contiguous()
    per_gauss = segment_sum(d_pre, ends, n).T                # [N, R]
    if grad_mode == "feature":
        return (None, None, None, None, per_gauss)
    base = len(GRAD_ROWS)
    d_features = per_gauss[:, base:] if has_features else None
    d_opacities = torch.where(visible, per_gauss[:, 5], 0.0)
    return (per_gauss[:, 0:2], per_gauss[:, 2:5], d_opacities, per_gauss[:, 6:9],
            d_features)


def rasterize(prep: PreprocessOut, inst: InstanceBuffer, opacities: torch.Tensor,
              features: torch.Tensor | None, bg: torch.Tensor, *, image_height: int,
              image_width: int, tile_size: int,
              means2d_override: torch.Tensor | None = None,
              grad_mode: str = "full") -> dict:
    """Differentiable tile rasterization: dict with `render` [3,H,W] (bg added to RGB),
    `final_transmittance` [H,W] and, with features, `language_feature_image` [F,H,W].

    Gradients reach means2d (or `means2d_override`, the screen-space tap), conics,
    opacities (zero where not visible), colors and features; with grad_mode "feature"
    only the features."""
    num_feat = 0 if features is None else features.shape[1]
    grad_rows(num_feat, grad_mode)   # validates grad_mode
    means2d = prep.means2d if means2d_override is None else means2d_override
    options = dict(grad_mode=grad_mode, size=dict(
        image_height=image_height, image_width=image_width, tile_size=tile_size))
    image, t_final = _Blend.apply(
        *(None if t is None else t.contiguous() for t in (
            means2d, prep.conics, opacities, prep.colors, features, prep.visible,
            inst.gauss_id, inst.tile_start, inst.presort_slot, inst.gauss_offsets, bg)),
        options)
    out = {"render": image[0:3], "final_transmittance": t_final}
    if features is not None:
        out["language_feature_image"] = image[3:]
    return out
