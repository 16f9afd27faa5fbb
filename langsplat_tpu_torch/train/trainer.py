"""Training steps and the Adam optimizer of the two training phases.

PyTorch counterpart of `langsplat_tpu/train/trainer.py`:
  - phase A (RGB): six parameter groups with their own learning rates, xyz on an
    exponential-decay schedule scaled by the scene extent, `f_rest` at feature_lr / 20,
    Adam with eps 1e-15;
  - phase B (language features): geometry frozen, Adam on `language_feature` only;
  - densification statistics from the screen-space means2D gradient tap;
  - Adam moment rows zeroed on densify/prune slot churn and on opacity resets.

The optimizer is written out rather than taken from `torch.optim`, so that it computes
what optax computes (`optax.adam` = scale_by_adam then scale by -lr; the xyz schedule
read at the update count before the update, as `optax.scale_by_schedule` does) and its
state is plain tensors whose rows can be zeroed, padded and saved. Steps are out of
place: they return a new field, optimizer state and statistics and leave their inputs
as they were, so the loop can drop a step whose render overflowed its caps and re-run
it, as the JAX loop does.

Spans (`utils/tracing.py`): `train_step`, and inside it `render` (ops/render.py),
`loss`, `backward` (the `torch.autograd.grad` call), `optimizer` (`Adam.update`) and,
in phase A, `stats` (the densification statistics and the PSNR).
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from langsplat_tpu_torch.core import losses
from langsplat_tpu_torch.models.gaussian_field import GaussianField
from langsplat_tpu_torch.ops.render import RenderSettings, render
from langsplat_tpu_torch.train.densify import DensifyStats, update_stats
from langsplat_tpu_torch.utils import tracing

PARAM_KEYS_RGB = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity")
PARAM_KEYS_FEATURE = ("language_feature",)
#: param key -> GaussianField attribute
FIELD_OF = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
            "scaling": "scaling", "rotation": "rotation", "opacity": "opacity",
            "language_feature": "language_feature"}
B1, B2, EPS = 0.9, 0.999, 1e-15


def expon_lr(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    """Log-linear learning-rate decay with an optional sine delay; the schedule maps an
    integer step to a float32 scalar tensor, computed in float32 as the JAX package
    does."""
    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=torch.float32)
        if lr_init == 0.0 and lr_final == 0.0:
            return torch.zeros_like(step)
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
        else:
            delay = 1.0
        t = torch.clamp(step / max_steps, 0, 1)
        log_lerp = torch.exp(np.float32(np.log(lr_init)) * (1 - t)
                             + np.float32(np.log(lr_final)) * t)
        return delay * log_lerp
    return schedule


def extract_params(field: GaussianField, include_feature: bool) -> dict:
    keys = PARAM_KEYS_FEATURE if include_feature else PARAM_KEYS_RGB
    return {k: getattr(field, FIELD_OF[k]) for k in keys}


def merge_params(field: GaussianField, params: dict) -> GaussianField:
    return replace(field, **{FIELD_OF[k]: v for k, v in params.items()})


def adam_direction(grads, mu, nu, count: torch.Tensor, eps: float):
    """optax.scale_by_adam (b1 0.9, b2 0.999, `eps` outside the square root) on lists of
    tensors that share one update count, in optax's float32 operations and order, as
    multi-tensor (foreach) operations. Returns (mu, nu, count, direction): the new
    moments and count, and each tensor's update before the learning rate's -lr scale.
    The inputs are left as they were."""
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - B1), torch._foreach_mul(mu, B1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2),
                            torch._foreach_mul(nu, B2))
    count = count + 1
    c = count.to(torch.float32)
    mu_hat = torch._foreach_div(mu, 1 - torch.pow(B1, c))
    nu_hat = torch._foreach_div(nu, 1 - torch.pow(B2, c))
    direction = torch._foreach_div(mu_hat,
                                   torch._foreach_add(torch._foreach_sqrt(nu_hat), eps))
    return mu, nu, count, direction


class Adam:
    """Adam per parameter group, as the JAX package's optax multi_transform: a constant
    learning rate per group, or, for xyz, -schedule(count) with the schedule's own
    count. State: {label: {"count", "mu", "nu"[, "sched_count"]}} of tensors."""

    def __init__(self, lrs: dict, schedules: dict | None = None):
        self.lrs = dict(lrs)
        self.schedules = dict(schedules or {})
        self.labels = tuple(sorted(list(self.lrs) + list(self.schedules)))

    def init(self, params: dict) -> dict:
        state = {}
        for label in self.labels:
            p = params[label]
            state[label] = dict(count=torch.zeros((), dtype=torch.int32, device=p.device),
                                mu=torch.zeros_like(p), nu=torch.zeros_like(p))
            if label in self.schedules:
                state[label]["sched_count"] = torch.zeros((), dtype=torch.int32,
                                                          device=p.device)
        return state

    def update(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        """(new params, new state); the inputs are left as they were."""
        new_params, new_state = dict(params), {}
        for label in self.labels:
            s = state[label]
            (mu,), (nu,), count, (step,) = adam_direction(
                [grads[label]], [s["mu"]], [s["nu"]], s["count"], EPS)
            ns = dict(count=count, mu=mu, nu=nu)
            if label in self.schedules:
                rate = -self.schedules[label](s["sched_count"]).to(step.device)
                ns["sched_count"] = s["sched_count"] + 1
                step = rate * step
            else:
                step = -self.lrs[label] * step
            new_params[label] = params[label] + step
            new_state[label] = ns
        return new_params, new_state


def make_optimizer(cfg, spatial_lr_scale: float, include_feature: bool) -> Adam:
    if include_feature:
        return Adam({"language_feature": cfg.language_feature_lr})
    xyz_sched = expon_lr(cfg.position_lr_init * spatial_lr_scale,
                         cfg.position_lr_final * spatial_lr_scale,
                         lr_delay_mult=cfg.position_lr_delay_mult,
                         max_steps=cfg.position_lr_max_steps)
    return Adam({"f_dc": cfg.feature_lr, "f_rest": cfg.feature_lr / 20.0,
                 "opacity": cfg.opacity_lr, "scaling": cfg.scaling_lr,
                 "rotation": cfg.rotation_lr}, schedules={"xyz": xyz_sched})


def zero_moment_rows(opt_state: dict, mask: torch.Tensor,
                     only_label: str | None = None) -> dict:
    """Zero the Adam mu/nu rows where `mask` [capacity] is True, in every group or only
    in `only_label`'s."""
    out = {}
    for label, s in opt_state.items():
        if only_label is not None and label != only_label:
            out[label] = s
            continue
        m = mask.reshape(mask.shape + (1,) * (s["mu"].dim() - 1))
        out[label] = dict(s, mu=torch.where(m, 0.0, s["mu"]),
                          nu=torch.where(m, 0.0, s["nu"]))
    return out


def pad_opt_state(opt_state: dict, old_cap: int, new_cap: int) -> dict:
    """Pad every [old_cap, ...] moment with zero rows (capacity growth)."""
    def pad(x):
        if x.dim() >= 1 and x.shape[0] == old_cap:
            block = torch.zeros((new_cap - old_cap,) + tuple(x.shape[1:]), dtype=x.dtype,
                                device=x.device)
            return torch.cat([x, block], dim=0)
        return x
    return {label: {k: pad(v) for k, v in s.items()} for label, s in opt_state.items()}


def opt_state_leaves(opt_state: dict) -> list[np.ndarray]:
    """The state as numpy leaves in the order of the JAX package's optax state leaves:
    labels sorted, then count, mu, nu and (xyz) the schedule count."""
    leaves = []
    for label in sorted(opt_state):
        s = opt_state[label]
        leaves += [s[k].detach().cpu().numpy()
                   for k in ("count", "mu", "nu", "sched_count") if k in s]
    return leaves


def opt_state_from_numpy(leaves, include_feature: bool,
                         device: str | torch.device) -> dict:
    """The optimizer state from numpy leaves in `opt_state_leaves` order, which is the
    leaf order of the JAX package's optax state (`jax.tree.leaves(opt_state)`), so
    either package's state carries across."""
    labels = sorted(PARAM_KEYS_FEATURE if include_feature else PARAM_KEYS_RGB)
    it = iter(leaves)
    state = {}
    for label in labels:
        s = {k: torch.as_tensor(np.array(next(it)), device=device)
             for k in ("count", "mu", "nu")}
        if label == "xyz":
            s["sched_count"] = torch.as_tensor(np.array(next(it)), device=device)
        state[label] = s
    if next(it, None) is not None:
        raise ValueError("more optimizer leaves than the phase's groups hold")
    return state


class StepOutput(NamedTuple):
    field: GaussianField
    opt_state: dict
    stats: DensifyStats
    loss: torch.Tensor
    l1: torch.Tensor
    psnr: torch.Tensor
    dropped: torch.Tensor       # budget-cap overflow (grow the instance budget)
    rect_dropped: torch.Tensor  # max_tiles-cap overflow (grow max_tiles_per_gaussian)


def _leaves(params: dict) -> dict:
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def rgb_loss_and_grads(field: GaussianField, viewmatrix, projmatrix, campos, gt_image,
                       bg, *, settings: RenderSettings, lambda_dssim: float):
    """Phase-A loss, its parameter gradients and the means2D tap's gradient:
    (loss, l1, render output, grads dict, screen-space grad [cap, 2])."""
    params = _leaves(extract_params(field, include_feature=False))
    tap = torch.zeros((field.capacity, 2), dtype=torch.float32, device=field.device,
                      requires_grad=True)
    out = render(merge_params(field, params), settings, viewmatrix, projmatrix, campos,
                 bg, screenspace_offset=tap)
    with tracing.span("loss"):
        l1 = losses.l1_loss(out["render"], gt_image)
        loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (
            1.0 - losses.ssim(out["render"], gt_image))
    keys = list(params)
    with tracing.span("backward"):
        grads = torch.autograd.grad(loss, [params[k] for k in keys] + [tap])
    return (loss.detach(), l1.detach(), out, dict(zip(keys, grads[:-1])), grads[-1])


def feature_loss_and_grads(field: GaussianField, viewmatrix, projmatrix, campos,
                           gt_feature, feature_mask, bg, *, settings: RenderSettings):
    """Phase-B masked L1 on the rendered language features and its gradient:
    (loss, render output, grads dict)."""
    params = _leaves(extract_params(field, include_feature=True))
    out = render(merge_params(field, params), settings, viewmatrix, projmatrix, campos,
                 bg)
    with tracing.span("loss"):
        loss = losses.masked_l1_loss(out["language_feature_image"], gt_feature,
                                     feature_mask)
    with tracing.span("backward"):
        (grad,) = torch.autograd.grad(loss, [params["language_feature"]])
    return loss.detach(), out, {"language_feature": grad}


@tracing.traced("train_step")
def train_step_rgb(field: GaussianField, opt_state: dict, stats: DensifyStats,
                   viewmatrix, projmatrix, campos, gt_image, bg, *,
                   settings: RenderSettings, optimizer: Adam,
                   lambda_dssim: float) -> StepOutput:
    loss, l1, out, grads, ss_grad = rgb_loss_and_grads(
        field, viewmatrix, projmatrix, campos, gt_image, bg, settings=settings,
        lambda_dssim=lambda_dssim)
    with torch.no_grad():
        with tracing.span("optimizer"):
            params, opt_state = optimizer.update(
                grads, opt_state, extract_params(field, include_feature=False))
        with tracing.span("stats"):
            stats = update_stats(stats, ss_grad, out["visibility_filter"], out["radii"],
                                 settings.image_width, settings.image_height)
            image = out["render"].detach()
            psnr = losses.psnr(torch.clamp(image, 0, 1), torch.clamp(gt_image, 0, 1))
    return StepOutput(merge_params(field, params), opt_state, stats, loss, l1, psnr,
                      out["instances_dropped"], out["rect_dropped"])


@tracing.traced("train_step")
def train_step_feature(field: GaussianField, opt_state: dict, stats: DensifyStats,
                       viewmatrix, projmatrix, campos, gt_feature, feature_mask, bg, *,
                       settings: RenderSettings, optimizer: Adam) -> StepOutput:
    """Phase-B step: masked L1 on the rendered language features, geometry frozen."""
    loss, out, grads = feature_loss_and_grads(
        field, viewmatrix, projmatrix, campos, gt_feature, feature_mask, bg,
        settings=settings)
    with torch.no_grad(), tracing.span("optimizer"):
        params, opt_state = optimizer.update(
            grads, opt_state, extract_params(field, include_feature=True))
    return StepOutput(merge_params(field, params), opt_state, stats, loss, loss,
                      torch.zeros((), device=loss.device), out["instances_dropped"],
                      out["rect_dropped"])
