"""PyTorch port, densification in the regime of trained fields, against the JAX package's
Pallas path (`backend="pallas", interpret=True`: the TPU kernels' own code).

A trained field is opaque and overlapping: many pixels end by the termination rule (T
would fall below TERM_EPS 1e-4), and where an opacity exceeds 0.99 the alpha near the
Gaussian's centre is clamped at ALPHA_MAX 0.99 (`ops/rasterize_reference.py:22-24`).
There the Pallas kernels take T as exp(cumsum(log(1 - a))) over lane chunks, where the
port keeps a running product, and both divide the backward's suffix sum Total - Prefix
by 1 - a, down to 0.01.

Each case builds such a field (200 Gaussians at 64x48), asserts its regime, takes the
real phase-A step (L1 + 0.2 D-SSIM, `train_step_rgb`) of three views in both packages
and holds:
  - visibility and radii equal;
  - the per-Gaussian densify statistic |d means2d . (W/2, H/2)| within REL_TOL (1e-3)
    relative for every Gaussian above 1% of the largest;
  - after the three views, the hot / clone / split / prune masks of `densify_core`
    equal, but for Gaussians within REL_TOL of the threshold (at most one), at a
    threshold inside the statistic's range (THRESHOLD_QUANTILE).

The cases: "opaque", overlapping Gaussians at opacities 0.99-0.9999, where at least 20%
of the pixels end; "clamped", a layer of dilated sub-pixel Gaussians on pixel centres in
front of a thin surface, where at least 5% of the blended alphas are clamped; and
"after_reset", the opaque field after `reset_opacity`, with the size threshold on. The
two regime shares do not meet in one field of this size: a Gaussian clamps only within
~0.14 sigma of its centre, ~0.2% of the pairs it blends, and a sub-pixel one clamps one
of its ~9 pairs, so 5% clamped needs most pairs to come from sub-pixel Gaussians, which
end no pixel.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.config import OptimizationConfig as JaxOptConfig
from langsplat_tpu.models.gaussian_field import GaussianField as JaxField
from langsplat_tpu.ops.render import RenderSettings as JaxSettings
from langsplat_tpu.train import densify as jdn
from langsplat_tpu.train import trainer as jtr
from langsplat_tpu_torch.config import OptimizationConfig
from langsplat_tpu_torch.core import transforms
from langsplat_tpu_torch.models.gaussian_field import FIELD_NAMES, from_numpy
from langsplat_tpu_torch.ops import projection, rasterize_reference
from langsplat_tpu_torch.ops.render import RenderSettings, render
from langsplat_tpu_torch.train import densify as tdn
from langsplat_tpu_torch.train import trainer as ttr

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import densify_ab  # noqa: E402  the A/B harness: its mask rule, comparisons and KNN copy

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

W, H, N = 64, 48, 200
REL_TOL = densify_ab.REL_TOL  # 1e-3 relative, above 1% of the largest statistic
# the densify threshold: this quantile of the JAX package's mean statistic over the
# visible Gaussians, so that the masks split every case's field (the protocol's 2e-4 is
# calibrated to 960x720 views of a scene, not to these)
THRESHOLD_QUANTILE = 60
EXTENT = 20.0             # the scene extent: Gaussians up to 0.2 clone, larger split
FOV = 0.9
Z_DETAIL = 3.0            # depth of the detail layer
SHIFTS = ((0, 0), (3, 0), (-2, 2))   # each view's shift of the detail layer, in pixels


def focal() -> np.ndarray:
    """(fx, fy) in pixels: the field of view FOV spans each axis."""
    return np.array([W, H]) / (2.0 * np.tan(FOV / 2))


def cameras():
    """Three views of the field, the camera translated in its image plane so that the
    detail layer at Z_DETAIL moves by whole pixels (SHIFTS)."""
    proj = transforms.projection_matrix(0.01, 100.0, FOV, FOV).T
    cams = []
    for sx, sy in SHIFTS:
        t = np.append(np.array([sx, sy]) * Z_DETAIL / focal(), 0.0)
        view = transforms.world_to_view(np.eye(3), t).T.astype(np.float32)
        cams.append(dict(viewmatrix=view, projmatrix=(view @ proj).astype(np.float32),
                         campos=np.linalg.inv(view)[3, :3].astype(np.float32)))
    return cams


def trained_field(kind: str, seed: int = 0) -> dict:
    """"opaque": overlapping Gaussians at depths 4-5 and opacities 0.99-0.9999, with 80
    sub-pixel ones in front; "clamped": 185 sub-pixel Gaussians at 0.995-0.9999 whose
    centres fall on pixel centres (at Z_DETAIL, in every view) in front of 15 small
    surface Gaussians."""
    rng = np.random.default_rng(seed)
    n_detail = 80 if kind == "opaque" else 185
    ns = N - n_detail
    box, lo, hi = (0.9, 0.25, 0.6) if kind == "opaque" else (1.4, 0.05, 0.2)
    surf = np.concatenate([rng.uniform(-box, box, (ns, 1)),
                           rng.uniform(-0.75 * box, 0.75 * box, (ns, 1)),
                           rng.uniform(4.0, 5.0, (ns, 1))], axis=1)
    pix = rng.choice(W * H, n_detail, replace=False)
    detail = np.stack([(pix % W - (W - 1) / 2) * Z_DETAIL / focal()[0],
                       (pix // W - (H - 1) / 2) * Z_DETAIL / focal()[1],
                       np.full(n_detail, Z_DETAIL)], axis=1)
    scales = np.concatenate([np.exp(rng.uniform(np.log(lo), np.log(hi), (ns, 3))),
                             np.full((n_detail, 3), 0.002)])
    opac = np.concatenate([rng.uniform(0.99 if kind == "opaque" else 0.9, 0.9999, ns),
                           rng.uniform(0.995, 0.9999, n_detail)])
    params = dict(xyz=np.concatenate([surf, detail]),
                  features_dc=rng.uniform(-1.5, 1.5, (N, 1, 3)),
                  features_rest=0.1 * rng.normal(size=(N, 3, 3)), scaling=np.log(scales),
                  rotation=rng.normal(size=(N, 4)),
                  opacity=np.log(opac / (1 - opac))[:, None])
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    params["language_feature"] = None
    params["alive"] = np.arange(N) % 50 != 7      # a few dead slots
    return params


def targets(params: dict, cams, sh_degree: int, seed: int = 1) -> list[np.ndarray]:
    """Ground truths close to the field's own renders, as a trained field has them: the
    renders of the field with its colours and positions perturbed."""
    rng = np.random.default_rng(seed)
    gt = dict(params, features_dc=params["features_dc"]
              + 0.15 * rng.normal(size=params["features_dc"].shape).astype(np.float32),
              xyz=params["xyz"] + 0.01 * rng.normal(size=params["xyz"].shape)
              .astype(np.float32))
    field = from_numpy(gt, "cpu")
    _, tset = settings(sh_degree)
    return [render(field, tset, *(torch.as_tensor(c[k]) for k in
                                  ("viewmatrix", "projmatrix", "campos")),
                   torch.zeros(3))["render"].clamp(0, 1).numpy() for c in cams]


def settings(sh_degree: int):
    common = dict(image_height=H, image_width=W, tanfovx=float(np.tan(FOV / 2)),
                  tanfovy=float(np.tan(FOV / 2)), sh_degree=sh_degree, budget=8192,
                  max_tiles_per_gaussian=16, include_feature=False, grad_mode="full")
    return (JaxSettings(chunk=32, interpret=True, backend="pallas", **common),
            RenderSettings(**common))


def regime(params: dict, cam: dict, sh_degree: int) -> tuple[float, float]:
    """(share of pixels whose transmittance falls below TERM_EPS, share of the blended
    alphas at ALPHA_MAX) of the field in this view, from the dense reference."""
    f = from_numpy(params, "cpu")
    t = {k: torch.as_tensor(v) for k, v in cam.items()}
    prep = projection.preprocess(
        f.xyz, f.get_scaling, f.rotation, f.get_features, t["viewmatrix"],
        t["projmatrix"], t["campos"], image_height=H, image_width=W,
        tanfovx=float(np.tan(FOV / 2)), tanfovy=float(np.tan(FOV / 2)),
        sh_degree=sh_degree, tile_size=16, alive=f.alive)
    order = torch.sort(torch.where(prep.visible, prep.depths, torch.inf), stable=True).indices
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32), indexing="ij")
    alphas = rasterize_reference.compute_alphas(
        prep.means2d[order], prep.conics[order], f.get_opacity[:, 0][order], xs, ys,
        prep.visible[order])
    weights, _ = rasterize_reference.blend_weights(alphas)
    ended = torch.prod(1.0 - alphas, dim=0) < rasterize_reference.TERM_EPS
    blended = weights > 0
    at_max = (alphas == rasterize_reference.ALPHA_MAX) & blended
    return float(ended.float().mean()), float(at_max.sum() / blended.sum())


def jax_views(params, cams, gts, sh_degree):
    jset, _ = settings(sh_degree)
    field = JaxField(**{k: None if params[k] is None else jnp.asarray(params[k])
                        for k in FIELD_NAMES})
    opt = jtr.make_optimizer(JaxOptConfig(), EXTENT, False)
    state = opt.init(jtr.extract_params(field, False))
    out = {"stat": [], "radii": []}
    for cam, gt in zip(cams, gts):
        s = jtr.train_step_rgb(field, state, jdn.DensifyStats.zeros(N),
                               *(jnp.asarray(cam[k]) for k in ("viewmatrix", "projmatrix",
                                                               "campos")),
                               jnp.asarray(gt), jnp.zeros(3, jnp.float32), settings=jset,
                               optimizer=opt, lambda_dssim=0.2)
        assert int(s.dropped) == int(s.rect_dropped) == 0
        out["stat"].append(np.asarray(s.stats.grad_accum))
        out["radii"].append(np.asarray(s.stats.max_radii2d))
    return out


def port_views(params, cams, gts, sh_degree):
    _, tset = settings(sh_degree)
    field = from_numpy(params, "cpu")
    opt = ttr.make_optimizer(OptimizationConfig(), EXTENT, False)
    state = opt.init(ttr.extract_params(field, False))
    out = {"stat": [], "radii": []}
    for cam, gt in zip(cams, gts):
        s = ttr.train_step_rgb(field, state, tdn.DensifyStats.zeros(N, "cpu"),
                               *(torch.as_tensor(cam[k]) for k in ("viewmatrix",
                                                                   "projmatrix", "campos")),
                               torch.as_tensor(gt), torch.zeros(3), settings=tset,
                               optimizer=opt, lambda_dssim=0.2)
        assert int(s.dropped) == int(s.rect_dropped) == 0
        out["stat"].append(s.stats.grad_accum.numpy())
        out["radii"].append(s.stats.max_radii2d.numpy())
    return out


def decide(params, views, threshold, use_size_threshold):
    """The masks of `densify_core` after the views are added to zero statistics."""
    stats = densify_ab.add_views(np.zeros((3, N), np.float32), views)
    return densify_ab.decisions(stats, params["opacity"][:, 0], params["scaling"],
                                params["alive"], extent=EXTENT, grad_threshold=threshold,
                                use_size_threshold=use_size_threshold)


def reset(params: dict) -> dict:
    """`train/densify.py reset_opacity`: opacities clamped to <= 0.01."""
    opa = np.minimum(1.0 / (1.0 + np.exp(-params["opacity"])), 0.01)
    return dict(params, opacity=np.log(opa / (1.0 - opa)).astype(np.float32))


@pytest.mark.parametrize("case", ["opaque", "clamped", "after_reset"])
def test_densify_statistic_and_decisions_match_the_pallas_path(case):
    sh_degree = 1
    params = trained_field("clamped" if case == "clamped" else "opaque")
    cams = cameras()
    gts = targets(params, cams, sh_degree)
    if case == "after_reset":
        params = reset(params)
    else:
        ended, at_max = zip(*(regime(params, c, sh_degree) for c in cams))
        print(f"{case}: pixels ended {ended}, blended alphas at ALPHA_MAX {at_max}")
        if case == "opaque":
            assert min(ended) >= 0.2 and min(at_max) > 0
        else:
            assert min(at_max) >= 0.05
    jv = jax_views(params, cams, gts, sh_degree)
    tv = port_views(params, cams, gts, sh_degree)
    for jg, jr, tg, tr in zip(jv["stat"], jv["radii"], tv["stat"], tv["radii"]):
        np.testing.assert_array_equal(tr, jr)
        d = densify_ab.stat_diff(jg, tg)
        print(f"{case}: {d['significant']} significant, max rel "
              f"{d['max_rel_significant']:.2e}")
        assert d["significant"] >= 50 and d["max_rel_significant"] <= REL_TOL
    jgrads = decide(params, jv, np.inf, False)["grads"]
    threshold = float(np.percentile(jgrads[jgrads > 0], THRESHOLD_QUANTILE))
    jm = decide(params, jv, threshold, case == "after_reset")
    tm = decide(params, tv, threshold, case == "after_reset")
    diff = densify_ab.decision_diff(jm, tm, threshold)
    print(f"{case}: threshold {threshold:.3e}, masks {diff}")
    assert 0 < diff["hot"]["count"][0] < params["alive"].sum()
    assert case == "clamped" or diff["prune"]["count"][0] > 0
    for k, d in diff.items():
        assert d["differ_not_near"] == 0 and d["differ"] <= 1, (k, d)


def test_knn_init_at_the_tpus_default_matmul_precision_floors_the_scales():
    """The scale initialisation's KNN (`langsplat_tpu/ops/knn.py:35`) forms its squared
    distances as |q|^2 - 2 q.p + |p|^2 with the cross term at Precision.DEFAULT, which the
    TPU runs as one bfloat16 pass and the CPU in float32. On points a few units from the
    origin and ~0.01 apart, as the quality protocol's SfM points are, the rounding of q
    and p to bfloat16 moves q.p by more than the distances themselves, and most squared
    distances come out <= 0, floored at 1e-7 by `create_from_pcd`: the TPU run's initial
    field is not the float32 one. The port's KNN and the JAX package's on the CPU agree;
    `scripts/densify_ab.py knn_sq_dist` is the package's function, line for line, with
    the TPU's rounding as an option."""
    from langsplat_tpu.ops import knn as jknn
    from langsplat_tpu_torch.ops import knn as tknn
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.uniform(2.2, 2.7, (1500, 2)), rng.uniform(0.3, 0.35, (1500, 1))],
                         axis=1).astype(np.float32)
    exact = np.asarray(jknn.mean_knn_sq_dist(jnp.asarray(pts)))
    knn = jax.jit(densify_ab.knn_sq_dist, static_argnames=("tpu_default", "k", "chunk"))
    np.testing.assert_array_equal(np.asarray(knn(jnp.asarray(pts), False)), exact)
    # both in float32: |q|^2 ~ 13 carries ~1e-6 of rounding into distances of ~2e-4
    port = tknn.mean_knn_sq_dist(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(port, exact, rtol=0, atol=1e-5)
    tpu = np.asarray(knn(jnp.asarray(pts), True))
    assert np.mean(exact <= 1e-7) == 0.0
    assert np.mean(tpu <= 1e-7) > 0.5, np.mean(tpu <= 1e-7)
