"""PyTorch port, training steps and optimizer against the JAX package (Pallas in
interpret mode on the JAX side, the plain blend on the port's):
  - the phase-A and phase-B loss to 1e-5 relative, and their gradients (the field's
    parameters and the means2D tap) to 5e-5 absolute;
  - one whole `train_step_rgb` / `train_step_feature` from the same field and optimizer
    state: loss, L1, PSNR and the densification statistics;
  - the optimizer on identical gradients against optax to 1e-6 relative, over several
    updates with moment zeroing and capacity padding in between, and the optimizer
    state carried across packages both ways (`opt_state_from_numpy`);
  - `expon_lr` against the JAX schedule.
Gradients are compared before the optimizer: Adam's first step is about lr * sign(g),
which turns rounding-level differences of near-zero gradients into differences of 2 lr.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from langsplat_tpu.config import OptimizationConfig as JaxOptConfig
from langsplat_tpu.core import losses as jlosses
from langsplat_tpu.models.gaussian_field import GaussianField as JaxField
from langsplat_tpu.ops.render import RenderSettings as JaxSettings
from langsplat_tpu.ops.render import render as jax_render
from langsplat_tpu.train import densify as jdn
from langsplat_tpu.train import loop as jloop
from langsplat_tpu.train import trainer as jtr
from langsplat_tpu_torch.config import OptimizationConfig
from langsplat_tpu_torch.models.gaussian_field import FIELD_NAMES, from_numpy
from langsplat_tpu_torch.ops.render import RenderSettings
from langsplat_tpu_torch.train import densify as tdn
from langsplat_tpu_torch.train import trainer as ttr

from tests.test_projection_and_dense import make_camera
from tests.test_tiles import random_scene

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

W, H, N = 48, 32, 80
LOSS_RTOL, GRAD_ATOL, OPT_RTOL = 1e-5, 5e-5, 1e-6


def field_params(with_feature):
    means, scales, quats, _, opac, _ = random_scene(N, seed=21, spread=1.5)
    rng = np.random.default_rng(22)
    params = dict(xyz=means, features_dc=rng.normal(size=(N, 1, 3)),
                  features_rest=0.2 * rng.normal(size=(N, 3, 3)), scaling=np.log(scales),
                  rotation=quats, opacity=np.log(opac / (1 - opac))[:, None],
                  language_feature=rng.normal(size=(N, 3)) if with_feature else None)
    params = {k: None if v is None else np.asarray(v, np.float32)
              for k, v in params.items()}
    params["alive"] = np.arange(N) < N - 6      # a few dead slots
    return params


def jax_field(params):
    return JaxField(**{k: None if params[k] is None else jnp.asarray(params[k])
                       for k in FIELD_NAMES})


def settings_pair(include_feature):
    cam = make_camera(w=W, h=H)
    common = dict(image_height=H, image_width=W, tanfovx=cam["tanfovx"],
                  tanfovy=cam["tanfovy"], sh_degree=1, budget=4096,
                  max_tiles_per_gaussian=16, include_feature=include_feature,
                  grad_mode="feature" if include_feature else "full")
    jset = JaxSettings(chunk=32, interpret=True, **common)
    mats = {k: np.asarray(cam[k], np.float32) for k in ("viewmatrix", "projmatrix",
                                                        "campos")}
    return jset, RenderSettings(**common), mats


def targets():
    rng = np.random.default_rng(23)
    return (rng.uniform(size=(3, H, W)).astype(np.float32),
            (rng.uniform(size=(1, H, W)) < 0.7).astype(np.float32))


def jmats(mats):
    return [jnp.asarray(mats[k]) for k in ("viewmatrix", "projmatrix", "campos")]


def tmats(mats):
    return [torch.tensor(mats[k]) for k in ("viewmatrix", "projmatrix", "campos")]


def test_rgb_loss_and_gradients_match_jax():
    params = field_params(False)
    jset, tset, mats = settings_pair(False)
    gt, _ = targets()
    bg = np.array([0.3, 0.1, 0.6], np.float32)
    jf = jax_field(params)

    def loss_fn(p, ss):
        out = jax_render(jtr.merge_params(jf, p), jset, *jmats(mats), jnp.asarray(bg),
                         screenspace_offset=ss)
        l1 = jlosses.l1_loss(out["render"], jnp.asarray(gt))
        return 0.8 * l1 + 0.2 * (1.0 - jlosses.ssim(out["render"], jnp.asarray(gt)))

    jloss, (jgrads, jtap) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        jtr.extract_params(jf, False), jnp.zeros((N, 2), jnp.float32))
    loss, _, _, grads, tap = ttr.rgb_loss_and_grads(
        from_numpy(params, "cpu"), *tmats(mats), torch.tensor(gt), torch.tensor(bg),
        settings=tset, lambda_dssim=0.2)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    for k in ttr.PARAM_KEYS_RGB:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   atol=GRAD_ATOL, err_msg=k)
        assert float(np.abs(np.asarray(jgrads[k])).max()) > 0, k
    np.testing.assert_allclose(tap.numpy(), np.asarray(jtap), atol=GRAD_ATOL)


def test_feature_loss_and_gradient_match_jax():
    params = field_params(True)
    jset, tset, mats = settings_pair(True)
    gt, mask = targets()
    bg = np.zeros(3, np.float32)
    jf = jax_field(params)

    def loss_fn(p):
        out = jax_render(jtr.merge_params(jf, p), jset, *jmats(mats), jnp.asarray(bg))
        return jlosses.masked_l1_loss(out["language_feature_image"], jnp.asarray(gt),
                                      jnp.asarray(mask))

    jloss, jgrads = jax.value_and_grad(loss_fn)(jtr.extract_params(jf, True))
    loss, _, grads = ttr.feature_loss_and_grads(
        from_numpy(params, "cpu"), *tmats(mats), torch.tensor(gt), torch.tensor(mask),
        torch.tensor(bg), settings=tset)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(grads["language_feature"].numpy(),
                               np.asarray(jgrads["language_feature"]), atol=GRAD_ATOL)


@pytest.mark.parametrize("phase", ["rgb", "feature"])
def test_whole_train_step_matches_jax(phase):
    include_feature = phase == "feature"
    params = field_params(include_feature)
    jset, tset, mats = settings_pair(include_feature)
    gt, mask = targets()
    bg = np.zeros(3, np.float32)
    jf = jax_field(params)
    jopt = jtr.make_optimizer(JaxOptConfig(), 2.0, include_feature)
    jstate = jopt.init(jtr.extract_params(jf, include_feature))
    tf = from_numpy(params, "cpu")
    topt = ttr.make_optimizer(OptimizationConfig(), 2.0, include_feature)
    tstate = ttr.opt_state_from_numpy([np.asarray(x) for x in jax.tree.leaves(jstate)],
                                      include_feature, "cpu")
    jstats, tstats = jdn.DensifyStats.zeros(N), tdn.DensifyStats.zeros(N, "cpu")
    if include_feature:
        j = jtr.train_step_feature.__wrapped__(
            jf, jstate, jstats, *jmats(mats), jnp.asarray(gt), jnp.asarray(mask),
            jnp.asarray(bg), settings=jset, optimizer=jopt)
        t = ttr.train_step_feature(tf, tstate, tstats, *tmats(mats), torch.tensor(gt),
                                   torch.tensor(mask), torch.tensor(bg), settings=tset,
                                   optimizer=topt)
    else:
        j = jtr.train_step_rgb.__wrapped__(
            jf, jstate, jstats, *jmats(mats), jnp.asarray(gt), jnp.asarray(bg),
            settings=jset, optimizer=jopt, lambda_dssim=0.2)
        t = ttr.train_step_rgb(tf, tstate, tstats, *tmats(mats), torch.tensor(gt),
                               torch.tensor(bg), settings=tset, optimizer=topt,
                               lambda_dssim=0.2)
    for name in ("loss", "l1", "psnr"):
        np.testing.assert_allclose(float(getattr(t, name)), float(getattr(j, name)),
                                   rtol=LOSS_RTOL, err_msg=name)
    assert int(t.dropped) == int(j.dropped) == 0
    for name in tdn.STAT_NAMES:
        want = np.asarray(getattr(j.stats, name))
        np.testing.assert_allclose(getattr(t.stats, name).numpy(), want,
                                   atol=GRAD_ATOL * max(1.0, float(np.abs(want).max())),
                                   err_msg=name)
    # the step left its inputs as they were and moved the parameters
    for k in ttr.extract_params(tf, include_feature):
        leaf = ttr.FIELD_OF[k]
        np.testing.assert_array_equal(getattr(tf, leaf).numpy(), params[leaf])
        assert not torch.equal(getattr(t.field, leaf), getattr(tf, leaf)), k
    assert [int(s["count"]) for s in t.opt_state.values()] == [1] * len(t.opt_state)


@pytest.mark.parametrize("include_feature", [False, True])
def test_optimizer_matches_optax_on_identical_gradients(include_feature):
    """Three updates with moment zeroing (densify churn, opacity reset) and a capacity
    growth in between; then the states carry across both ways."""
    cfg, jcfg = OptimizationConfig(), JaxOptConfig()
    params = field_params(include_feature)
    keys = ttr.PARAM_KEYS_FEATURE if include_feature else ttr.PARAM_KEYS_RGB
    jp = jtr.extract_params(jax_field(params), include_feature)
    tp = ttr.extract_params(from_numpy(params, "cpu"), include_feature)
    jopt = jtr.make_optimizer(jcfg, 2.5, include_feature)
    topt = ttr.make_optimizer(cfg, 2.5, include_feature)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(31)
    cap = N
    for step in range(3):
        g = {k: (rng.normal(size=tp[k].shape) * 10.0 ** rng.integers(-6, 0)
                 ).astype(np.float32) for k in keys}
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                      jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp, tstate = topt.update({k: torch.tensor(v) for k, v in g.items()}, tstate, tp)
        for k in keys:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=OPT_RTOL,
                                       atol=1e-9, err_msg=f"step {step} {k}")
        if step == 0:
            mask = rng.uniform(size=cap) < 0.3
            jstate = jtr.zero_moment_rows(jstate, jnp.asarray(mask), cap)
            tstate = ttr.zero_moment_rows(tstate, torch.tensor(mask))
            if not include_feature:
                jstate = jtr.zero_moment_rows(jstate, jnp.ones(cap, bool), cap,
                                              only_label="opacity")
                tstate = ttr.zero_moment_rows(tstate, torch.ones(cap, dtype=torch.bool),
                                              only_label="opacity")
        if step == 1:
            jstate = jloop.pad_opt_state(jstate, cap, cap + 16)
            tstate = ttr.pad_opt_state(tstate, cap, cap + 16)
            jp = {k: jnp.concatenate([v, jnp.zeros((16,) + v.shape[1:])]) for k, v in
                  jp.items()}
            tp = {k: torch.cat([v, torch.zeros((16,) + tuple(v.shape[1:]))]) for k, v in
                  tp.items()}
            cap += 16
        jleaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
        tleaves = ttr.opt_state_leaves(tstate)
        assert len(jleaves) == len(tleaves)
        for a, b in zip(tleaves, jleaves):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, rtol=OPT_RTOL, atol=1e-12)
    # carried across: the port from optax's leaves, and optax from the port's
    back = ttr.opt_state_from_numpy(jleaves, include_feature, "cpu")
    for a, b in zip(ttr.opt_state_leaves(back), jleaves):
        np.testing.assert_array_equal(a, b)
    jtree = jax.tree.unflatten(jax.tree.structure(jstate),
                               [jnp.asarray(x) for x in ttr.opt_state_leaves(tstate)])
    assert jax.tree.structure(jtree) == jax.tree.structure(jstate)


def test_expon_lr_matches_jax():
    args = (1.6e-4 * 3.0, 1.6e-6 * 3.0)
    for kw in (dict(max_steps=30_000), dict(lr_delay_steps=100, lr_delay_mult=0.01,
                                            max_steps=1000)):
        js, ts = jtr.expon_lr(*args, **kw), ttr.expon_lr(*args, **kw)
        for step in (0, 1, 57, 999, 5000, 30_000, 40_000):
            np.testing.assert_allclose(float(ts(step)), float(js(step)), rtol=OPT_RTOL)
    assert float(ttr.expon_lr(0.0, 0.0)(10)) == 0.0
