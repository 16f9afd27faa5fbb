"""The plain reference of a render and of LangSplat's two training steps.

Phase A (RGB): loss (1 - l) L1 + l (1 - SSIM) with an 11x11 sigma-1.5 window (zero
padding, two separable passes of shifted multiply-adds), six parameter groups under
Adam as optax computes it (b1 0.9, b2 0.999, eps 1e-15 outside the square root; xyz on
the exponential-decay schedule read at its count before the update; f_rest at a
twentieth of the feature rate), and the densification statistics from the screen-space
gradient scaled to half-image units. Phase B (features): the masked L1 of the rendered
unit language features, Adam on the language features alone.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port.reference import FLOAT32, Precision
from bench_port.reference.geometry import View, project
from bench_port.reference.raster import bin_instances, blend

B1, B2, EPS = 0.9, 0.999, 1e-15
RGB_LEAVES = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
FEATURE_LEAVES = ("language_feature",)
STAT_LEAVES = ("grad_accum", "denom", "max_radii2d")


def unit_features(lf: torch.Tensor) -> torch.Tensor:
    return lf / (torch.sqrt(torch.sum(lf * lf, dim=-1, keepdim=True) + 1e-18) + 1e-9)


def render(leaves: dict, view: View, *, sh_degree: int, tile_size: int,
           include_feature: bool, feature_only: bool = False, tap=None,
           pr: Precision = FLOAT32) -> dict:
    """One view: `render` [3, H, W], `features` [F, H, W] or None, `t_final`, `radii`,
    `visible`, and `pairs` (evaluated, blended) and `instances` of the blend."""
    shs = torch.cat([leaves["f_dc"], leaves["f_rest"]], dim=1)
    prep = project(pr(leaves["xyz"]), pr(torch.exp(leaves["scaling"])),
                   pr(leaves["rotation"]), pr(shs), leaves["alive"], view, sh_degree,
                   tile_size)
    opac = pr(torch.sigmoid(leaves["opacity"])[:, 0])
    means2d = pr(prep.means2d) if tap is None else pr(prep.means2d) + tap
    conics, colors = pr(prep.conics), pr(prep.colors)
    inst = bin_instances(prep._replace(means2d=pr(prep.means2d).detach(),
                                       conics=conics.detach()),
                         opac.detach(), view.width, view.height, tile_size)
    attrs = colors
    if include_feature:
        attrs = torch.cat([colors.detach() if feature_only else colors,
                           pr(unit_features(leaves["language_feature"]))], dim=1)
    bg = torch.zeros(3, dtype=torch.float32, device=means2d.device)
    image, t_final, pairs = blend(means2d, conics, opac, attrs, prep.visible, bg, inst,
                                  (view.width, view.height, tile_size), feature_only)
    image, t_final = pr(image), pr(t_final)
    return dict(render=image[:3], features=image[3:] if include_feature else None,
                t_final=t_final, radii=prep.radii, visible=prep.visible, pairs=pairs,
                instances=inst.count)


def _blur(img, window, dim):
    r = len(window) // 2
    pad = (r, r, 0, 0) if dim == -1 else (0, 0, r, r)
    padded = torch.nn.functional.pad(img, pad)
    size = img.shape[dim]
    out = window[0] * padded.narrow(dim, 0, size)
    for i in range(1, len(window)):
        out = out + window[i] * padded.narrow(dim, i, size)
    return out


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    xs = np.arange(11) - 5
    g = np.exp(-(xs ** 2) / (2.0 * 1.5 ** 2))
    window = tuple((g / g.sum()).astype(np.float32).tolist())

    def blur(x):
        return _blur(_blur(x, window, -2), window, -1)

    mu1, mu2 = blur(a), blur(b)
    s1 = blur(a * a) - mu1 * mu1
    s2 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean(((2.0 * mu1 * mu2 + c1) * (2.0 * s12 + c2))
                      / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)))


def rows_of(x: torch.Tensor, rows: slice | None) -> torch.Tensor:
    return x if rows is None else x[..., rows, :]


def xyz_rate(count: int, init: float, final: float, max_steps: int) -> float:
    """The xyz learning rate at schedule count `count` (no delay), in float32."""
    t = min(max(np.float32(count) / np.float32(max_steps), np.float32(0)), np.float32(1))
    lerp = np.float32(np.log(init)) * (np.float32(1) - t) + np.float32(np.log(final)) * t
    return float(np.exp(lerp))


class Adam:
    """optax.adam per group, with the state as plain tensors."""

    def __init__(self, rates: dict, xyz_schedule: tuple | None = None):
        self.rates, self.xyz_schedule = rates, xyz_schedule

    def init(self, params: dict) -> dict:
        return {k: dict(mu=torch.zeros_like(v), nu=torch.zeros_like(v), count=0)
                for k, v in params.items()}

    def update(self, grads: dict, state: dict, params: dict,
               pr: Precision = FLOAT32) -> tuple[dict, dict]:
        new_params, new_state = {}, {}
        for k, p in params.items():
            g, s = grads[k], state[k]
            mu = pr(g * (1 - B1) + s["mu"] * B1)
            nu = pr((g * g) * (1 - B2) + s["nu"] * B2)
            count = s["count"] + 1
            c = torch.tensor(float(count), dtype=torch.float32)
            mu_hat = mu / (1 - torch.pow(torch.tensor(B1, dtype=torch.float32), c)).item()
            nu_hat = nu / (1 - torch.pow(torch.tensor(B2, dtype=torch.float32), c)).item()
            direction = mu_hat / (torch.sqrt(nu_hat) + EPS)
            if k == "xyz" and self.xyz_schedule is not None:
                rate = xyz_rate(s["count"], *self.xyz_schedule)
            else:
                rate = self.rates[k]
            new_params[k] = pr(p + (-rate) * direction)
            new_state[k] = dict(mu=mu, nu=nu, count=count)
        return new_params, new_state


def optimizer(phase: str, opt: dict, extent: float) -> Adam:
    """The phase's Adam from the optimization settings `opt` (the program's defaults,
    copied into the cell's mix) and the scene extent."""
    if phase == "B":
        return Adam({"language_feature": opt["language_feature_lr"]})
    return Adam({"f_dc": opt["feature_lr"], "f_rest": opt["feature_lr"] / 20.0,
                 "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
                 "rotation": opt["rotation_lr"]},
                xyz_schedule=(opt["position_lr_init"] * extent,
                              opt["position_lr_final"] * extent,
                              opt["position_lr_max_steps"]))


def step(phase: str, leaves: dict, adam: Adam, state: dict, stats: dict, view: View,
         target: dict, *, sh_degree: int, tile_size: int, lambda_dssim: float,
         pr: Precision = FLOAT32, loss_rows: slice | None = None) -> dict:
    """One training step. `target` holds `image` [3, H, W] (phase A) or `features`
    [F, H, W] and `mask` [1, H, W] (phase B). With `loss_rows`, the loss is the mean over
    those image rows alone (a fault the comparison must catch). Returns the new leaves,
    state and statistics, the loss, the gradients and the blend's pair counts."""
    names = RGB_LEAVES if phase == "A" else FEATURE_LEAVES
    params = {k: pr(leaves[k]).detach().requires_grad_(True) for k in names}
    fixed = {k: v for k, v in leaves.items() if k not in params}
    tap = None
    if phase == "A":
        tap = torch.zeros((leaves["xyz"].shape[0], 2), dtype=torch.float32,
                          device=leaves["xyz"].device, requires_grad=True)
    out = render({**fixed, **params}, view, sh_degree=sh_degree, tile_size=tile_size,
                 include_feature=phase == "B", feature_only=phase == "B", tap=tap, pr=pr)
    if phase == "A":
        img, gt = rows_of(out["render"], loss_rows), rows_of(target["image"], loss_rows)
        loss = (1.0 - lambda_dssim) * torch.mean(torch.abs(img - gt)) \
            + lambda_dssim * (1.0 - ssim(img, gt))
        wrt = [params[k] for k in names] + [tap]
    else:
        m = rows_of(target["mask"], loss_rows)
        loss = torch.mean(torch.abs(rows_of(out["features"], loss_rows) * m
                                    - rows_of(target["features"], loss_rows) * m))
        wrt = [params[k] for k in names]
    grads = torch.autograd.grad(loss, wrt)
    grads_d = {k: pr(g) for k, g in zip(names, grads)}
    with torch.no_grad():
        new_params, state = adam.update(grads_d, state, {k: params[k].detach()
                                                         for k in names}, pr)
        if phase == "A":
            scale = torch.tensor([0.5 * view.width, 0.5 * view.height],
                                 dtype=torch.float32, device=tap.device)
            gnorm = torch.linalg.vector_norm(grads[-1] * scale, dim=-1)
            vis = out["visible"].to(torch.float32)
            stats = dict(grad_accum=stats["grad_accum"] + gnorm * vis,
                         denom=stats["denom"] + vis,
                         max_radii2d=torch.maximum(
                             stats["max_radii2d"],
                             torch.where(out["visible"], out["radii"].to(torch.float32),
                                         0.0)))
    return dict(leaves={**leaves, **new_params}, state=state, stats=stats,
                loss=float(loss.detach()), grads=grads_d, pairs=out["pairs"],
                instances=out["instances"])


def zero_stats(n: int, device) -> dict:
    return {k: torch.zeros(n, dtype=torch.float32, device=device) for k in STAT_LEAVES}


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def run_steps(phase: str, leaves: dict, views: list, targets: list, *, opt: dict,
              extent: float, sh_degree: int, tile_size: int, lambda_dssim: float,
              pr: Precision = FLOAT32, loss_rows: slice | None = None) -> dict:
    """The reference's readings of len(views) steps from `leaves`: each step's loss,
    the first step's gradient norm per leaf, and after the last step the norm of each
    leaf's change (and of each densification statistic in phase A)."""
    adam = optimizer(phase, opt, extent)
    names = RGB_LEAVES if phase == "A" else FEATURE_LEAVES
    state = adam.init({k: leaves[k] for k in names})
    n = leaves["xyz"].shape[0]
    stats = zero_stats(n, leaves["xyz"].device)
    start = {k: leaves[k].clone() for k in names}
    cur, losses, first_grads, pairs = leaves, [], None, []
    for view, target in zip(views, targets):
        out = step(phase, cur, adam, state, stats, view, target, sh_degree=sh_degree,
                   tile_size=tile_size, lambda_dssim=lambda_dssim, pr=pr,
                   loss_rows=loss_rows)
        cur, state, stats = out["leaves"], out["state"], out["stats"]
        losses.append(out["loss"])
        pairs.append((out["instances"],) + tuple(out["pairs"]))
        if first_grads is None:
            first_grads = {k: norm(g) for k, g in out["grads"].items()}
    change = {k: norm(cur[k] - start[k]) for k in names}
    if phase == "A":
        change.update({k: norm(v) for k, v in stats.items()})
    return dict(losses=losses, grads=first_grads, change=change, pairs=pairs)


def render_view(leaves: dict, view: View, *, sh_degree: int, tile_size: int,
                include_feature: bool, pr: Precision = FLOAT32) -> dict:
    """The reference's render of one view, without gradients."""
    with torch.no_grad():
        return render(leaves, view, sh_degree=sh_degree, tile_size=tile_size,
                      include_feature=include_feature, pr=pr)

