"""Tile binning and the tile blend, forward and backward, in plain PyTorch.

Binning lists every (Gaussian, tile) pair of each visible Gaussian's whole tile rect
(no cap on the rect) that can receive alpha >= 1/255, by the conservative test of the
minimum of the conic's quadratic over the tile's pixel box, and orders the pairs by
tile, then depth, ties by Gaussian index. The blend walks every tile's list one depth
step at a time for all tiles at once, so memory stays O(image + instances). The
backward replays the forward front to back and sums each instance's gradient over its
tile's pixels; the per-Gaussian sum adds the instances in float64.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench_port.reference.geometry import Projected

ALPHA_EPS = 1.0 / 255.0
TERM_EPS = 1e-4
ALPHA_MAX = 0.99


class Instances(NamedTuple):
    gauss_id: torch.Tensor    # [M] int64, sorted by (tile, depth, index)
    tile_start: torch.Tensor  # [tiles + 1] int64
    count: int


def bin_instances(prep: Projected, opacities: torch.Tensor, width: int, height: int,
                  tile_size: int) -> Instances:
    gx, gy = -(-width // tile_size), -(-height // tile_size)
    n = prep.means2d.shape[0]
    device = prep.means2d.device
    w = prep.tiles_max[:, 0] - prep.tiles_min[:, 0]
    h = prep.tiles_max[:, 1] - prep.tiles_min[:, 1]
    rect = torch.where(prep.visible, w * h, 0).to(torch.int64)
    gid = torch.repeat_interleave(torch.arange(n, device=device), rect)
    pos = torch.arange(gid.shape[0], device=device) - (torch.cumsum(rect, 0) - rect)[gid]
    wg = torch.clamp_min(w, 1).to(torch.int64)[gid]
    tx = prep.tiles_min[gid, 0].to(torch.int64) + pos % wg
    ty = prep.tiles_min[gid, 1].to(torch.int64) + pos // wg

    # the cull: alpha = opa exp(-Q) reaches 1/255 only where Q <= ln(opa * 255)
    lam = (torch.tensor(-math.log(ALPHA_EPS), dtype=torch.float32, device=device)
           + torch.log(torch.clamp_min(opacities.reshape(-1), 1e-12)))[gid]
    ts = float(tile_size)
    mx, my = prep.means2d[gid, 0], prep.means2d[gid, 1]
    ca, cb, cc = prep.conics[gid, 0], prep.conics[gid, 1], prep.conics[gid, 2]
    x0 = tx.to(torch.float32) * ts - mx
    x1 = x0 + (ts - 1.0)
    y0 = ty.to(torch.float32) * ts - my
    y1 = y0 + (ts - 1.0)
    inside = (x0 <= 0.0) & (0.0 <= x1) & (y0 <= 0.0) & (0.0 <= y1)

    def q(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    ca_s, cc_s = torch.clamp_min(ca, 1e-12), torch.clamp_min(cc, 1e-12)
    qmin = torch.minimum(
        torch.minimum(q(x0, clip(-cb * x0 / cc_s, y0, y1)),
                      q(x1, clip(-cb * x1 / cc_s, y0, y1))),
        torch.minimum(q(clip(-cb * y0 / ca_s, x0, x1), y0),
                      q(clip(-cb * y1 / ca_s, x0, x1), y1)))
    keep = torch.where(inside, 0.0, qmin) <= lam
    gid, tile = gid[keep], (ty * gx + tx)[keep]

    depth = torch.where(prep.visible, prep.depths, torch.inf)
    rank = torch.empty(n, dtype=torch.int64, device=device)
    rank[torch.sort(depth, stable=True).indices] = torch.arange(n, device=device)
    key = tile * n + rank[gid]
    order = torch.sort(key).indices
    gid, tile = gid[order], tile[order]
    tile_start = torch.searchsorted(tile, torch.arange(gx * gy + 1, device=device))
    return Instances(gid, tile_start, int(gid.shape[0]))


def _pixels(width, height, tile_size, device):
    gx, gy = -(-width // tile_size), -(-height // tile_size)
    tiles = torch.arange(gx * gy, device=device)
    lp = torch.arange(tile_size * tile_size, device=device)
    px = ((tiles % gx) * tile_size)[:, None] + lp % tile_size
    py = ((tiles // gx) * tile_size)[:, None] + lp // tile_size
    return px, py, (px < width) & (py < height)


def _to_image(x, width, height, tile_size):
    """[tiles, C, P] -> [C, H, W]."""
    gx, gy = -(-width // tile_size), -(-height // tile_size)
    c = x.shape[1]
    img = x.reshape(gy, gx, c, tile_size, tile_size).permute(2, 0, 3, 1, 4)
    return img.reshape(c, gy * tile_size, gx * tile_size)[:, :height, :width]


def _to_tiles(img, tile_size):
    """[C, H, W] -> [tiles, C, P], zero past the image edge."""
    c, h, w = img.shape
    gx, gy = -(-w // tile_size), -(-h // tile_size)
    img = torch.nn.functional.pad(img, (0, gx * tile_size - w, 0, gy * tile_size - h))
    img = img.reshape(c, gy, tile_size, gx, tile_size).permute(1, 3, 0, 2, 4)
    return img.reshape(gy * gx, c, tile_size * tile_size)


def _falloff(means2d, conics, opa, gid, fx, fy):
    m, co, o = means2d[gid], conics[gid], opa[gid]
    dx = fx - m[:, 0:1]
    dy = fy - m[:, 1:2]
    power = -0.5 * (co[:, 0:1] * dx * dx + co[:, 2:3] * dy * dy) - co[:, 1:2] * dx * dy
    gexp = torch.exp(torch.clamp_max(power, 0.0))
    raw = o[:, None] * gexp
    return dx, dy, power, gexp, raw, torch.clamp_max(raw, ALPHA_MAX)


class Blended(NamedTuple):
    image: torch.Tensor      # [3 + F, H, W], background on RGB
    t_final: torch.Tensor    # [H, W]
    evaluated: int           # (instance, pixel) pairs evaluated before pixels ended
    blended: int             # pairs blended


def blend_forward(means2d, conics, opacities, visible, attrs, inst: Instances, bg,
                  width, height, tile_size) -> Blended:
    """attrs [N, 3 + F]: colors, then the features."""
    device = means2d.device
    opa = torch.where(visible, opacities, 0.0)
    starts, counts = inst.tile_start[:-1], inst.tile_start[1:] - inst.tile_start[:-1]
    px, py, inside = _pixels(width, height, tile_size, device)
    fx, fy = px.to(torch.float32), py.to(torch.float32)
    t = torch.ones(px.shape, dtype=torch.float32, device=device)
    acc = torch.zeros((px.shape[0], attrs.shape[1], px.shape[1]), dtype=torch.float32,
                      device=device)
    done = ~inside
    evaluated = torch.zeros((), dtype=torch.int64, device=device)
    blended = torch.zeros((), dtype=torch.int64, device=device)
    last = max(inst.count - 1, 0)
    for k in range(int(counts.max()) if inst.count else 0):
        if k % 32 == 0 and bool(done.all()):
            break
        has = k < counts
        live = has[:, None] & ~done
        gid = torch.where(has, inst.gauss_id[torch.clamp(starts + k, max=last)], 0)
        _, _, power, _, _, alpha = _falloff(means2d, conics, opa, gid, fx, fy)
        ok = live & (power <= 0.0) & (alpha >= ALPHA_EPS)
        test_t = t * (1.0 - alpha)
        term = ok & (test_t < TERM_EPS)
        blend = ok & ~term
        acc = acc + torch.where(blend, alpha * t, 0.0)[:, None, :] * attrs[gid][:, :, None]
        t = torch.where(blend, test_t, t)
        evaluated += live.sum()
        blended += blend.sum()
        done = done | term
    acc = torch.cat([acc[:, :3] + t[:, None, :] * bg[None, :, None], acc[:, 3:]], dim=1)
    return Blended(_to_image(acc, width, height, tile_size),
                   _to_image(t[:, None], width, height, tile_size)[0],
                   int(evaluated), int(blended))


def blend_backward(means2d, conics, opacities, visible, attrs, inst: Instances,
                   g_image, g_tail, total, feature_only: bool, width, height,
                   tile_size) -> torch.Tensor:
    """Per-instance gradient sums [R, M] (rows mean_x, mean_y, conic a, b, c, opacity,
    then the attributes; only the features with `feature_only`) from the image
    gradient, g_tail = dL/dT_final (the background's share included) times T_final,
    and total = sum_ch g_ch out_ch (without the background)."""
    device = means2d.device
    opa = torch.where(visible, opacities, 0.0)
    starts, counts = inst.tile_start[:-1], inst.tile_start[1:] - inst.tile_start[:-1]
    px, py, inside = _pixels(width, height, tile_size, device)
    fx, fy = px.to(torch.float32), py.to(torch.float32)
    g = _to_tiles(g_image, tile_size)
    tot = _to_tiles(total[None], tile_size)[:, 0]
    tail = _to_tiles(g_tail[None], tile_size)[:, 0]
    t = torch.ones(px.shape, dtype=torch.float32, device=device)
    prefix = torch.zeros(px.shape, dtype=torch.float32, device=device)
    done = ~inside
    rows = attrs.shape[1] - 3 if feature_only else 6 + attrs.shape[1]
    d_inst = torch.zeros((rows, max(inst.count, 1)), dtype=torch.float32, device=device)
    last = max(inst.count - 1, 0)
    for k in range(int(counts.max()) if inst.count else 0):
        if k % 32 == 0 and bool(done.all()):
            break
        has = k < counts
        idx = torch.clamp(starts + k, max=last)
        gid = torch.where(has, inst.gauss_id[idx], 0)
        dx, dy, power, gexp, raw, alpha = _falloff(means2d, conics, opa, gid, fx, fy)
        ok = has[:, None] & ~done & (power <= 0.0) & (alpha >= ALPHA_EPS)
        test_t = t * (1.0 - alpha)
        term = ok & (test_t < TERM_EPS)
        blend = ok & ~term
        w = torch.where(blend, alpha * t, 0.0)
        if feature_only:
            per_pixel = g[:, 3:] * w[:, None, :]
        else:
            gdot = (g * attrs[gid][:, :, None]).sum(dim=1)
            prefix = prefix + w * gdot
            suffix = (tot - prefix) + tail
            dalpha = torch.where(blend, t * gdot - suffix / (1.0 - alpha), 0.0)
            dag = torch.where(raw < ALPHA_MAX, dalpha, 0.0)
            dpower = dag * alpha
            co = conics[gid]
            a, b, c = co[:, 0:1], co[:, 1:2], co[:, 2:3]
            per_pixel = torch.cat([
                torch.stack([dpower * (a * dx + b * dy), dpower * (c * dy + b * dx),
                             -0.5 * dpower * dx * dx, -dpower * dx * dy,
                             -0.5 * dpower * dy * dy, dag * gexp], dim=1),
                g * w[:, None, :]], dim=1)
        d_inst[:, idx[has]] = per_pixel.sum(dim=2)[has].T
        t = torch.where(blend, test_t, t)
        done = done | term
    return d_inst


def per_gaussian(d_inst: torch.Tensor, inst: Instances, n: int) -> torch.Tensor:
    """[N, R]: each Gaussian's instance rows added in float64."""
    out = torch.zeros((n, d_inst.shape[0]), dtype=torch.float64, device=d_inst.device)
    if inst.count:
        out.index_add_(0, inst.gauss_id, d_inst[:, :inst.count].T.to(torch.float64))
    return out.to(torch.float32)


class _Blend(torch.autograd.Function):
    """The blend with its backward: gradients reach means2d, conics, opacities (zero
    where not visible) and the attributes; with `feature_only` only the features.
    The forward's pair counts go into `holder`."""

    @staticmethod
    def forward(ctx, means2d, conics, opacities, attrs, visible, bg, inst, size,
                feature_only, holder):
        out = blend_forward(means2d, conics, opacities, visible, attrs, inst, bg, *size)
        ctx.inst, ctx.size, ctx.feature_only = inst, size, feature_only
        ctx.save_for_backward(means2d, conics, opacities, attrs, visible, bg,
                              out.image, out.t_final)
        holder["pairs"] = (out.evaluated, out.blended)
        return out.image, out.t_final

    @staticmethod
    def backward(ctx, g_image, g_t):
        means2d, conics, opacities, attrs, visible, bg, image, t_final = ctx.saved_tensors
        g_bg = (g_image[:3] * bg[:, None, None]).sum(dim=0)
        total = (g_image * image).sum(dim=0) - g_bg * t_final
        # dL/dT_final enters the suffix of every blended pair times T_final
        g_tail = (g_t + g_bg) * t_final
        d_inst = blend_backward(means2d, conics, opacities, visible, attrs, ctx.inst,
                                g_image.contiguous(), g_tail, total, ctx.feature_only,
                                *ctx.size)
        per = per_gaussian(d_inst, ctx.inst, means2d.shape[0])
        none = (None,) * 6
        if ctx.feature_only:
            d_attrs = torch.zeros_like(attrs)
            d_attrs[:, 3:] = per
            return (None, None, None, d_attrs) + none
        d_opa = torch.where(visible, per[:, 5], 0.0)
        return (per[:, 0:2], per[:, 2:5], d_opa, per[:, 6:]) + none


def blend(means2d, conics, opacities, attrs, visible, bg, inst, size, feature_only=False):
    """(image [3 + F, H, W], final T [H, W], (evaluated, blended) pairs); `size` is
    (width, height, tile_size)."""
    holder = {}
    image, t_final = _Blend.apply(means2d, conics, opacities, attrs, visible, bg, inst,
                                  size, feature_only, holder)
    return image, t_final, holder["pairs"]
