"""PyTorch port, training steps and optimizer against the JAX package (Pallas in
interpret mode on the JAX side, the plain blend on the port's):
  - the phase-A and phase-B loss to 1e-5 relative, and their gradients (the field's
    parameters and the means2D tap) to 5e-5 absolute;
  - one whole `train_step_rgb` / `train_step_feature` from the same field and optimizer
    state: loss, L1, PSNR and the densification statistics;
  - the optimizer on identical gradients against optax to 1e-6 relative, over several
    updates with moment zeroing and capacity padding in between, and the optimizer
    state carried across packages both ways (`opt_state_from_numpy`);
  - `expon_lr` against the JAX schedule;
  - Adam on CPU tensors launches no kernel; the kernel's wrapper (`adam_update_cuda`)
    rehearsed on CPU memory, its table read and written by an emulation of
    csrc/adam.cu's arithmetic, bit-equal to the plain version, in every card-test case.
Gradients are compared before the optimizer: Adam's first step is about lr * sign(g),
which turns rounding-level differences of near-zero gradients into differences of 2 lr.
"""

import ctypes

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
from langsplat_tpu_torch.ops import _build
from langsplat_tpu_torch.ops.render import RenderSettings
from langsplat_tpu_torch.train import densify as tdn
from langsplat_tpu_torch.train import trainer as ttr

from tests.test_projection_and_dense import make_camera
from tests.test_torch_cuda import ADAM_CASES, adam_case
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


def test_adam_on_cpu_tensors_launches_no_kernel():
    """`Adam.update` on CPU tensors takes the plain version: no launch counter moves,
    and the state matches optax's leaf for leaf."""
    cfg, jcfg = OptimizationConfig(), JaxOptConfig()
    params = field_params(False)
    jp = jtr.extract_params(jax_field(params), False)
    tp = ttr.extract_params(from_numpy(params, "cpu"), False)
    jopt, topt = jtr.make_optimizer(jcfg, 2.5, False), ttr.make_optimizer(cfg, 2.5, False)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    rng = np.random.default_rng(32)
    g = {k: rng.normal(size=tp[k].shape).astype(np.float32) for k in ttr.PARAM_KEYS_RGB}
    launches = dict(_build.LAUNCHES)
    tp, tstate = topt.update({k: torch.tensor(v) for k, v in g.items()}, tstate, tp)
    assert dict(_build.LAUNCHES) == launches
    _, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
    for a, b in zip(ttr.opt_state_leaves(tstate), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=OPT_RTOL, atol=1e-12)


def _cpu_array(address: int, n: int, ctype) -> np.ndarray:
    """n values of `ctype` at `address` of this process's memory, as a writable view."""
    return np.ctypeslib.as_array((ctype * n).from_address(address)) if n else \
        np.zeros(0, np.float32)


def _cpu_rows(address: int, rows: int, row: int, stride: int) -> np.ndarray:
    """rows x row float32 values at `address`, rows `stride` elements apart, flat."""
    if rows * row == 0:
        return np.zeros(0, np.float32)
    span = _cpu_array(address, (rows - 1) * stride + row, ctypes.c_float)
    return np.lib.stride_tricks.as_strided(span, (rows, row), (4 * stride, 4)).reshape(-1)


def emulated_adam_update(calls: list):
    """A stand-in for the `adam_update` entry point on CPU memory: csrc/adam.cu's
    arithmetic, element by element in float32, read and written through the table's
    pointers; each call's groups are recorded in `calls`."""
    def launch(device, table, n_groups, b1, one_minus_b1, b2, one_minus_b2, eps):
        calls.append([dict(grad=gr.grad, row=gr.row, stride=tuple(gr.stride))
                      for gr in table[:n_groups]])
        b1, omb1, b2, omb2, eps = (np.float32(x) for x in (b1, one_minus_b1, b2,
                                                          one_minus_b2, eps))
        for gr in table[:n_groups]:
            count = int(_cpu_array(gr.count, 1, ctypes.c_int32)[0])
            c = torch.tensor(float(count + 1))
            bc1 = (1 - torch.pow(ttr.B1, c)).numpy()
            bc2 = (1 - torch.pow(ttr.B2, c)).numpy()
            neg_lr = -_cpu_array(gr.rate, 1, ctypes.c_float)[0] if gr.rate else \
                np.float32(gr.neg_lr)
            rows = gr.n // gr.row
            p, g, m, v = (_cpu_rows(getattr(gr, k), rows, gr.row, gr.stride[i])
                          for i, k in enumerate(("param", "grad", "mu", "nu")))
            m2 = g * omb1 + m * b1
            v2 = (g * g) * omb2 + v * b2
            # the square root as torch's on the CPU, which is not always correctly
            # rounded there (its AVX-512 path); sqrtf on the card is, as torch's is
            root = torch.sqrt(torch.from_numpy(v2 / bc2)).numpy()
            step = (m2 / bc1) / (root + eps)
            for k, x in (("param_out", p + step * neg_lr), ("mu_out", m2), ("nu_out", v2)):
                _cpu_array(getattr(gr, k), gr.n, ctypes.c_float)[:] = x
            _cpu_array(gr.count_out, 1, ctypes.c_int32)[0] = count + 1
            if gr.sched_count:
                _cpu_array(gr.sched_count_out, 1, ctypes.c_int32)[0] = \
                    _cpu_array(gr.sched_count, 1, ctypes.c_int32)[0] + 1
    return launch


def leaves_of(params, state, grads) -> list:
    return [*params.values(), *grads.values(),
            *(v for s in state.values() for v in s.values())]


@pytest.mark.parametrize("case", ADAM_CASES)
def test_adam_kernel_wrapper_rehearsed_on_the_cpu(monkeypatch, case):
    """`adam_update_cuda` on CPU tensors with the entry point emulated: its table (the
    pointers, sizes, -lr, the schedule's rate, the counts) gives new params and state
    bit-equal to `Adam.update_plain`, in one launch, leaving the inputs as they were."""
    calls = []
    monkeypatch.setattr(ttr, "_ADAM", emulated_adam_update(calls))
    optimizer, grads, state, params = adam_case(case, torch.device("cpu"))
    before = [t.clone() for t in leaves_of(params, state, grads)]
    want_p, want_s = optimizer.update_plain(grads, state, params)
    rates = {k: f(state[k]["sched_count"]) for k, f in optimizer.schedules.items()}
    got_p, got_s = ttr.adam_update_cuda(grads, state, params, optimizer.lrs, rates)
    assert [len(c) for c in calls] == [len(optimizer.labels)]
    # row-strided gradients are read where they are, without a copy; others through one
    for k, group in zip(optimizer.labels, calls[0]):
        if ttr._rows_contiguous(grads[k]):
            assert group["grad"] == grads[k].data_ptr(), k
            assert group["stride"][1] == (grads[k].stride(0) if grads[k].dim() else 1), k
        else:
            assert group["grad"] != grads[k].data_ptr(), k
            assert group["stride"][1] == group["row"], k
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k]), k
        assert list(got_s[k]) == list(want_s[k]), k
        for leaf, want in want_s[k].items():
            assert got_s[k][leaf].dtype == want.dtype and torch.equal(got_s[k][leaf], want)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves_of(params, state, grads)))


@pytest.mark.parametrize("fault", ["dtype", "shape", "count", "rate", "out", "groups"])
def test_adam_kernel_wrapper_refuses_what_it_does_not_take(monkeypatch, fault):
    """float32 leaves of one shape a group, int32 scalar counts, a float32 scalar rate,
    outputs of the same and at most ADAM_MAX_GROUPS groups: anything else raises before
    a launch."""
    calls = []
    monkeypatch.setattr(ttr, "_ADAM", emulated_adam_update(calls))
    optimizer, grads, state, params = adam_case("rgb_200", torch.device("cpu"))
    rates = {k: f(state[k]["sched_count"]) for k, f in optimizer.schedules.items()}
    lrs, out = optimizer.lrs, None
    if fault == "dtype":
        grads = dict(grads, f_dc=grads["f_dc"].double())
    elif fault == "shape":
        grads = dict(grads, rotation=grads["rotation"][:, :3])
    elif fault == "groups":
        more = [f"more{i}" for i in range(ttr.ADAM_MAX_GROUPS)]
        params = dict(params, **dict.fromkeys(more, params["opacity"]))
        grads = dict(grads, **dict.fromkeys(more, grads["opacity"]))
        state = dict(state, **dict.fromkeys(more, state["opacity"]))
        lrs = dict(lrs, **dict.fromkeys(more, 1e-3))
    elif fault == "count":
        state = dict(state, opacity=dict(state["opacity"], count=torch.zeros(1)))
    elif fault == "rate":
        rates = {k: v.reshape(1, 1) for k, v in rates.items()}
    else:
        out = {k: dict(param=torch.empty(v.shape[::-1]).permute(
                           *range(v.dim() - 1, -1, -1)), mu=torch.empty_like(v),
                       nu=torch.empty_like(v), count=torch.zeros((), dtype=torch.int32),
                       **({"sched_count": torch.zeros((), dtype=torch.int32)}
                          if k in rates else {}))
               for k, v in params.items()}
    with pytest.raises(ValueError):
        ttr.adam_update_cuda(grads, state, params, lrs, rates, out=out)
    assert calls == []
