"""Tile blend forward: the CUDA kernel `csrc/blend_fwd.cu`, its wrapper, and its plain
PyTorch version.

Port of the forward half of `langsplat_tpu/ops/rasterize_pallas.py` (the `_fwd_kernel`
blend, `:597`), with the output contract of `rasterize_pallas` (`:1247-1288`): `render`
with `bg` added to RGB only, `final_transmittance`, and `language_feature_image`.

Only the semantics cross over. The TPU path packs every instance's attributes into a
128-lane-aligned buffer (`pack_instances`), fuses several tiles per grid step (`NMEMB`,
`GROUP_SORT`, `_build_sched`) and runs the transmittance as an MXU cumsum of logs; none
of that is needed here. The kernel gathers each tile's instances straight from the
per-Gaussian arrays. This slice is forward only: nothing here records gradients.

Dispatch is by device only: tensors on the CPU go to the plain version, tensors on a
CUDA device go to the kernel, and anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from langsplat_tpu_torch.ops import _build
from langsplat_tpu_torch.ops.projection import PreprocessOut
from langsplat_tpu_torch.ops.rasterize_reference import ALPHA_EPS, ALPHA_MAX, TERM_EPS
from langsplat_tpu_torch.ops.tiles import InstanceBuffer

#: the kernel's tile edge (one 256-thread block per 16x16 tile)
KERNEL_TILE = 16
#: most language-feature channels the kernel is instantiated for
MAX_FEATURES = 8

_SOURCE = "blend_fwd.cu"


def _grid(image_height: int, image_width: int, tile_size: int) -> tuple[int, int]:
    return -(-image_width // tile_size), -(-image_height // tile_size)


def _blend_plain(means2d, conics, opacities, visible, colors, features, gauss_id,
                 tile_start, bg, *, image_height, image_width, tile_size):
    """The kernel's arithmetic in plain PyTorch, all tiles at once, one instance depth
    step at a time (memory stays O(image) whatever the instance count).

    Returns (image [3+F, H, W], final T [H, W], evaluated [H, W], blended [H, W]): the
    last two count, per pixel, the instances evaluated before the pixel ended
    (the ending one included) and the instances blended into it.
    """
    device = means2d.device
    ts = tile_size
    grid_x, grid_y = _grid(image_height, image_width, ts)
    num_tiles = grid_x * grid_y
    attrs = colors if features is None else torch.cat([colors, features], dim=1)
    opa = torch.where(visible, opacities, 0.0)
    starts = tile_start[:-1].to(torch.int64)
    counts = (tile_start[1:] - tile_start[:-1]).to(torch.int64)

    tiles = torch.arange(num_tiles, device=device)
    lp = torch.arange(ts * ts, device=device)
    px = ((tiles % grid_x) * ts)[:, None] + lp % ts            # [NT, P]
    py = ((tiles // grid_x) * ts)[:, None] + lp // ts
    inside = (px < image_width) & (py < image_height)
    fx, fy = px.to(torch.float32), py.to(torch.float32)

    T = torch.ones(px.shape, dtype=torch.float32, device=device)
    acc = torch.zeros((num_tiles, attrs.shape[1]) + px.shape[1:], dtype=torch.float32,
                      device=device)
    done = ~inside
    evaluated = torch.zeros(px.shape, dtype=torch.int64, device=device)
    blended = torch.zeros(px.shape, dtype=torch.int64, device=device)
    depth = int(counts.max()) if num_tiles else 0
    last = max(gauss_id.shape[0] - 1, 0)
    for k in range(depth):
        if k % 32 == 0 and bool(done.all()):
            break
        live = (k < counts)[:, None] & ~done                   # [NT, P]
        gid = gauss_id[torch.clamp(starts + k, max=last)].to(torch.int64)
        gid = torch.where(k < counts, gid, 0)
        m, co, o = means2d[gid], conics[gid], opa[gid]
        dx = fx - m[:, 0:1]
        dy = fy - m[:, 1:2]
        power = (-0.5 * (co[:, 0:1] * dx * dx + co[:, 2:3] * dy * dy)
                 - co[:, 1:2] * dx * dy)
        alpha = torch.clamp_max(o[:, None] * torch.exp(torch.clamp_max(power, 0.0)),
                                ALPHA_MAX)
        ok = live & (power <= 0.0) & (alpha >= ALPHA_EPS)
        test_t = T * (1.0 - alpha)
        term = ok & (test_t < TERM_EPS)
        blend = ok & ~term
        w = torch.where(blend, alpha * T, 0.0)
        acc += w[:, None, :] * attrs[gid][:, :, None]
        T = torch.where(blend, test_t, T)
        evaluated += live
        blended += blend
        done = done | term

    acc[:, :3] += T[:, None, :] * bg[None, :, None]

    def to_image(x):   # [NT, C, P] -> [C, H, W]
        c = x.shape[1]
        img = x.reshape(grid_y, grid_x, c, ts, ts).permute(2, 0, 3, 1, 4)
        return img.reshape(c, grid_y * ts, grid_x * ts)[:, :image_height, :image_width]

    return (to_image(acc), to_image(T[:, None])[0], to_image(evaluated[:, None])[0],
            to_image(blended[:, None])[0])


def blend_forward_plain(means2d, conics, opacities, visible, colors, features, gauss_id,
                        tile_start, bg, *, image_height, image_width, tile_size):
    """Plain PyTorch version of `blend_forward` (same arguments and results)."""
    image, t_final, _, _ = _blend_plain(
        means2d, conics, opacities, visible, colors, features, gauss_id, tile_start, bg,
        image_height=image_height, image_width=image_width, tile_size=tile_size)
    return image, t_final


def evaluated_pairs(means2d, conics, opacities, visible, colors, features, gauss_id,
                    tile_start, bg, *, image_height, image_width,
                    tile_size) -> tuple[int, int]:
    """(instance, pixel) pairs the blend evaluates before each pixel ends, and the pairs
    it blends, for these inputs (from the plain version): the work a kernel has to do."""
    _, _, evaluated, blended = _blend_plain(
        means2d, conics, opacities, visible, colors, features, gauss_id, tile_start, bg,
        image_height=image_height, image_width=image_width, tile_size=tile_size)
    return int(evaluated.sum()), int(blended.sum())


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def blend_forward_cuda(means2d, conics, opacities, visible, colors, features, gauss_id,
                       tile_start, bg, *, image_height, image_width, tile_size):
    """Launch the blend kernel on the tensors' CUDA device and current stream."""
    device = means2d.device
    if device.type != "cuda":
        raise ValueError(f"blend_forward_cuda needs CUDA tensors, got {device}")
    if tile_size != KERNEL_TILE:
        raise ValueError(f"the blend kernel takes tile_size {KERNEL_TILE}, got {tile_size}")
    n = means2d.shape[0]
    num_feat = 0 if features is None else features.shape[1]
    if num_feat > MAX_FEATURES:
        raise ValueError(f"the blend kernel takes at most {MAX_FEATURES} feature "
                         f"channels, got {num_feat}")
    grid_x, grid_y = _grid(image_height, image_width, tile_size)
    num_tiles = grid_x * grid_y
    f32 = torch.float32
    _check("means2d", means2d, f32, (n, 2), device)
    _check("conics", conics, f32, (n, 3), device)
    _check("opacities", opacities, f32, (n,), device)
    _check("visible", visible, torch.bool, (n,), device)
    _check("colors", colors, f32, (n, 3), device)
    if features is not None:
        _check("features", features, f32, (n, num_feat), device)
    _check("gauss_id", gauss_id, torch.int32, (gauss_id.shape[0],), device)
    _check("tile_start", tile_start, torch.int32, (num_tiles + 1,), device)
    _check("bg", bg, f32, (3,), device)

    lib = _build.load(_SOURCE)
    fn = lib.blend_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    image = torch.empty((3 + num_feat, image_height, image_width), dtype=f32,
                        device=device)
    t_final = torch.empty((image_height, image_width), dtype=f32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(means2d.data_ptr(), conics.data_ptr(), opacities.data_ptr(),
                 visible.data_ptr(), colors.data_ptr(),
                 None if features is None else features.data_ptr(),
                 gauss_id.data_ptr(), tile_start.data_ptr(), bg.data_ptr(),
                 num_feat, image_height, image_width, grid_x, num_tiles,
                 image.data_ptr(), t_final.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed with CUDA error {err}")
    _build.LAUNCHES["blend_fwd"] += 1
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


def rasterize_forward(prep: PreprocessOut, inst: InstanceBuffer, opacities: torch.Tensor,
                      features: torch.Tensor | None, bg: torch.Tensor, *,
                      image_height: int, image_width: int, tile_size: int) -> dict:
    """Tile rasterization forward: dict with `render` [3,H,W] (bg added to RGB),
    `final_transmittance` [H,W] and, with features, `language_feature_image` [F,H,W]."""
    image, t_final = blend_forward(
        *blend_args(prep, inst, opacities, features, bg),
        image_height=image_height, image_width=image_width, tile_size=tile_size)
    out = {"render": image[0:3], "final_transmittance": t_final}
    if features is not None:
        out["language_feature_image"] = image[3:]
    return out
