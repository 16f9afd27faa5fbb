"""Tiled blend in plain PyTorch: each tile blends at most `max_per_tile` of its
depth-sorted instances (the farthest are truncated), on any device.

PyTorch-port counterpart of `langsplat_tpu/ops/rasterize_tiled.py`, the JAX package's
backend behind `--interpret`: it takes the `InstanceBuffer` of `tiles.bin_gaussians`,
gathers up to `max_per_tile` instances per tile (a padding slot `n` reads zeros and an
off-screen mean), and blends them with `rasterize_reference.blend_weights`. The
forward runs over chunks of tiles, so its [tiles, max_per_tile, pixels] intermediates
stay bounded (at 1024x768 one such tensor over every tile would be 3.2 GB).

Gradients are deterministic on the card. The backward recomputes each chunk with the
gathered per-instance attributes as leaves, so autograd yields one gradient row per
instance without a scatter-add; the rows go to the instance's pre-sort slot and are
reduced per Gaussian by `segment_sum` (the segment-sum kernel on the card), as the
blend kernels' backward does. The JAX version relies on XLA's deterministic scatter
instead. It has no kernel of its own.
"""

from __future__ import annotations

import torch

from langsplat_tpu_torch.ops.projection import PreprocessOut
from langsplat_tpu_torch.ops.rasterize_cuda import (_pixel_grid, _to_image, _to_tiles,
                                                    grad_rows, reduce_instance_grads)
from langsplat_tpu_torch.ops.rasterize_reference import ALPHA_EPS, ALPHA_MAX, blend_weights
from langsplat_tpu_torch.ops.tiles import InstanceBuffer

#: elements of one [tiles, instances, pixels] intermediate per chunk (128 MB of float32)
CHUNK_ELEMENTS = 1 << 25


def truncated_tiles(inst: InstanceBuffer, max_per_tile: int) -> int:
    """Tiles holding more than max_per_tile instances (the backend drops the rest)."""
    return int(((inst.tile_start[1:] - inst.tile_start[:-1]) > max_per_tile).sum())


def _padded(means2d, conics, opacities, colors, features):
    """The per-Gaussian arrays with one dead slot appended (index n): an off-screen mean,
    a unit conic, zero opacity and zero attributes."""
    def pad(x, value):
        return torch.cat([x, torch.full((1,) + x.shape[1:], value, dtype=x.dtype,
                                        device=x.device)])
    attrs = colors if features is None else torch.cat([colors, features], dim=1)
    return pad(means2d, -1e8), pad(conics, 1.0), pad(opacities, 0.0), pad(attrs, 0.0)


def _slots(gauss_id, tile_start, tiles, depth, n):
    """For the tiles `tiles` [T]: the buffer index of each of their first `depth`
    instances [T, K] (clamped), whether it lies in the tile's range, and its Gaussian
    (n for padding)."""
    budget = gauss_id.shape[0]
    start = tile_start[tiles].to(torch.int64)
    end = tile_start[tiles + 1].to(torch.int64)
    pos = start[:, None] + torch.arange(depth, device=gauss_id.device)
    in_range = pos < end[:, None]
    idx = torch.clamp(pos, max=budget - 1)
    gid = torch.where(in_range, gauss_id[idx].to(torch.int64), n)
    return idx, in_range, gid


def _blend_chunk(m, co, o, attrs, in_range, fx, fy, bg):
    """Blend [T, K] gathered instances (means m [T,K,2], conics co [T,K,3], opacities o
    [T,K], attributes [T,K,C]) over their tiles' pixels fx, fy [T, P]: (per-tile values
    [T, C, P] with bg added to the RGB rows, final T [T, P])."""
    dx = fx[:, None, :] - m[..., 0:1]
    dy = fy[:, None, :] - m[..., 1:2]
    a, b, c = co[..., 0:1], co[..., 1:2], co[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    keep_p = (power <= 0.0) & in_range[..., None]
    alpha = torch.clamp_max(o[..., None] * torch.exp(torch.where(keep_p, power, -1.0)),
                            ALPHA_MAX)
    alpha = torch.where(keep_p & (alpha >= ALPHA_EPS), alpha, 0.0)
    weights, t_final = blend_weights(alpha.transpose(0, 1))        # [K, T, P], [T, P]
    out = torch.einsum("ktp,tkc->tcp", weights, attrs)
    rgb = out[:, :3] + t_final[:, None, :] * bg[None, :, None]
    return torch.cat([rgb, out[:, 3:]], dim=1), t_final


def _chunks(num_tiles, depth, pixels):
    step = max(1, CHUNK_ELEMENTS // max(1, depth * pixels))
    for t0 in range(0, num_tiles, step):
        yield t0, min(t0 + step, num_tiles)


class _TiledBlend(torch.autograd.Function):
    """The tiled forward and its deterministic backward (per-instance rows, then the
    per-Gaussian segment sum)."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, colors, features, visible, gauss_id,
                tile_start, presort_slot, gauss_offsets, bg, options):
        size = options["size"]
        n = means2d.shape[0]
        m, co, o, attrs = _padded(means2d, conics, opacities, colors, features)
        px, py, _ = _pixel_grid(size["image_height"], size["image_width"],
                                size["tile_size"], means2d.device)
        fx, fy = px.to(torch.float32), py.to(torch.float32)
        num_tiles = px.shape[0]
        counts = tile_start[1:] - tile_start[:-1]
        depth = max(1, min(options["max_per_tile"], int(counts.max()) if num_tiles else 0))
        tiles_out = torch.empty((num_tiles, attrs.shape[1], px.shape[1]),
                                dtype=torch.float32, device=means2d.device)
        tiles_t = torch.empty(px.shape, dtype=torch.float32, device=means2d.device)
        for t0, t1 in _chunks(num_tiles, depth, px.shape[1]):
            tiles = torch.arange(t0, t1, device=means2d.device)
            _, in_range, gid = _slots(gauss_id, tile_start, tiles, depth, n)
            tiles_out[t0:t1], tiles_t[t0:t1] = _blend_chunk(
                m[gid], co[gid], o[gid], attrs[gid], in_range, fx[t0:t1], fy[t0:t1], bg)
        ctx.options = dict(options, depth=depth)
        ctx.save_for_backward(means2d, conics, opacities, colors, features, visible,
                              gauss_id, tile_start, presort_slot, gauss_offsets, bg)
        return (_to_image(tiles_out, **size),
                _to_image(tiles_t[:, None], **size)[0])

    @staticmethod
    def backward(ctx, g_image, g_t):
        (means2d, conics, opacities, colors, features, visible, gauss_id, tile_start,
         presort_slot, gauss_offsets, bg) = ctx.saved_tensors
        size, depth = ctx.options["size"], ctx.options["depth"]
        grad_mode = ctx.options["grad_mode"]
        feature_only = grad_mode == "feature"
        n, budget = means2d.shape[0], gauss_id.shape[0]
        num_feat = 0 if features is None else features.shape[1]
        m, co, o, attrs = _padded(means2d, conics, opacities, colors, features)
        px, py, _ = _pixel_grid(size["image_height"], size["image_width"],
                                size["tile_size"], means2d.device)
        fx, fy = px.to(torch.float32), py.to(torch.float32)
        g_tiles = _to_tiles(g_image.contiguous(), size["tile_size"])     # [NT, C, P]
        g_t_tiles = _to_tiles(g_t[None].contiguous(), size["tile_size"])[:, 0]
        d_pre = torch.zeros((grad_rows(num_feat, grad_mode), budget), dtype=torch.float32,
                            device=means2d.device)
        for t0, t1 in _chunks(px.shape[0], depth, px.shape[1]):
            tiles = torch.arange(t0, t1, device=means2d.device)
            idx, in_range, gid = _slots(gauss_id, tile_start, tiles, depth, n)
            # per-instance leaves: their gradients are the per-instance rows
            leaves = [x[gid].detach() for x in (m, co, o, attrs[..., :3], attrs[..., 3:])]
            wrt = leaves[4:] if feature_only else leaves
            with torch.enable_grad():
                for x in wrt:
                    x.requires_grad_(True)
                out, t_final = _blend_chunk(
                    leaves[0], leaves[1], leaves[2], torch.cat(leaves[3:], dim=-1),
                    in_range, fx[t0:t1], fy[t0:t1], bg)
                # in grad mode "feature" T does not depend on the leaves
                outputs = (out,) if feature_only else (out, t_final)
                grads = torch.autograd.grad(outputs, wrt,
                                            (g_tiles[t0:t1], g_t_tiles[t0:t1])[
                                                :len(outputs)])
            grads = [g[..., None] if g.dim() == 2 else g for g in grads]   # opacity
            rows = torch.cat(grads, dim=-1).reshape(-1, d_pre.shape[0])
            slot = presort_slot[idx.reshape(-1)].to(torch.int64)
            keep = in_range.reshape(-1) & (slot < budget)
            d_pre[:, slot[keep]] = rows[keep].T
        return reduce_instance_grads(d_pre, gauss_offsets, visible, features is not None,
                                     grad_mode) + (None,) * 7


def rasterize_tiled(prep: PreprocessOut, inst: InstanceBuffer, opacities: torch.Tensor,
                    features: torch.Tensor | None, bg: torch.Tensor, *, image_height: int,
                    image_width: int, tile_size: int, max_per_tile: int,
                    means2d_override: torch.Tensor | None = None,
                    grad_mode: str = "full") -> dict:
    """Differentiable tiled rasterization with the output and gradient contract of
    `rasterize_cuda.rasterize` (`render` [3,H,W] with bg added, `final_transmittance`
    [H,W], `language_feature_image` [F,H,W] with features), blending at most
    `max_per_tile` instances per tile."""
    num_feat = 0 if features is None else features.shape[1]
    grad_rows(num_feat, grad_mode)   # validates grad_mode
    means2d = prep.means2d if means2d_override is None else means2d_override
    options = dict(grad_mode=grad_mode, max_per_tile=max_per_tile, size=dict(
        image_height=image_height, image_width=image_width, tile_size=tile_size))
    image, t_final = _TiledBlend.apply(
        *(None if t is None else t.contiguous() for t in (
            means2d, prep.conics, opacities, prep.colors, features, prep.visible,
            inst.gauss_id, inst.tile_start, inst.presort_slot, inst.gauss_offsets, bg)),
        options)
    out = {"render": image[0:3], "final_transmittance": t_final}
    if features is not None:
        out["language_feature_image"] = image[3:]
    return out
