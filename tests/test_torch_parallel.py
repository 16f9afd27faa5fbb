"""PyTorch port, multi-device layouts against the JAX package's on the same seeded numpy
inputs. The port's ranks are processes (`parallel/launch.py`, gloo, one thread a rank),
spawned twice for the whole file: 2 ranks for the 1-D layouts, 4 for the 2x2 meshes;
each runs the tasks of `parallel/runner.py`. The JAX side runs the same layout on a CPU
mesh of the same size (tiled backend). Held at PERF.md §2's limits: images 3e-5,
gradients 5e-5, parameters after the optimizer 1e-6 (from a warm Adam state, so that
rounding-level gradient differences stay rounding-level), densify decisions equal:
  - the data-parallel step, RGB and feature, and ZeRO-2 (equal to the port's replicated
    step within 1e-6, and to JAX's);
  - the tile-band render and its gradients; the 2x2 ('data', 'tiles') step;
  - the depth-sharded render, its gradients, its feature step, and `render_full`'s
    budget and max_tiles growth;
  - the Gaussian-sharded step on ('gauss',), ('data', 'gauss') and in the feature phase;
  - the sharded densify's decisions against the serial rule, and its conservative
    overflow;
  - the Gaussian-sharded layout's viewer field: gathered on every rank while rank 0's
    viewer is connected, by no rank while none is;
  - every collective and the gather's backward against the CPU arithmetic; the mesh
    factorization; a failing rank ends the run, named by the first stamped failure;
    NCCL refuses more ranks than cards.
"""

import dataclasses
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.config import OptimizationConfig as JaxOptConfig
from langsplat_tpu.ops.render import RenderSettings as JaxSettings
from langsplat_tpu.parallel import mesh as jmesh
from langsplat_tpu.train import densify as jdn
from langsplat_tpu.train import trainer as jtr
from langsplat_tpu_torch.config import OptimizationConfig
from langsplat_tpu_torch.models.gaussian_field import (FIELD_NAMES, create_from_pcd,
                                                       from_numpy)
from langsplat_tpu_torch.ops.render import RenderSettings
from langsplat_tpu_torch.parallel import gauss_sharded, launch, mesh, runner
from langsplat_tpu_torch.train import trainer as ttr

from tests.test_parallel import batched_cameras

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

W, H, V = 32, 48, 4            # 3 tile rows: 2 bands leave the second half padding
IMG_ATOL, GRAD_ATOL, OPT_ATOL, LOSS_RTOL = 3e-5, 5e-5, 1e-6, 1e-5
RUN_TIMEOUT = 150.0             # seconds a spawned run may take
TEST_TIMEOUT = 120              # seconds a test's body may take
dn_names = ("grad_accum", "denom", "max_radii2d")


def pcd_params(n, cap, seed):
    """`tests.test_model_train.make_field`'s field, made by the port's create_from_pcd."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)), rng.uniform(4, 7, (n, 1))],
                         axis=1).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    f = create_from_pcd(pts, cols, sh_degree=1, device="cpu", capacity=cap)
    return {k: getattr(f, k).numpy() for k in FIELD_NAMES if getattr(f, k) is not None}


def field_params(seed, include_feature=False, n=24, cap=32):
    params = pcd_params(n, cap, seed)
    rng = np.random.default_rng(seed + 100)
    params["xyz"] = params["xyz"] + rng.normal(0, 0.08, (cap, 3)).astype(np.float32)
    params["opacity"] = (params["opacity"] + 2.0).astype(np.float32)
    # anisotropic, rotated Gaussians, so every parameter has a gradient
    params["scaling"] = (params["scaling"] + rng.normal(0, 0.3, (cap, 3))).astype(np.float32)
    params["rotation"] = (params["rotation"] + rng.normal(0, 0.3, (cap, 4))).astype(np.float32)
    if include_feature:
        params["language_feature"] = rng.normal(size=(cap, 3)).astype(np.float32)
    return params


def jax_field(params):
    from langsplat_tpu.models.gaussian_field import GaussianField
    return GaussianField(**{k: None if params.get(k) is None else jnp.asarray(params[k])
                            for k in FIELD_NAMES})


def settings_pair(include_feature, h=H, w=W, **kw):
    _, _, _, tanf = batched_cameras(v=1, w=w, h=h)
    common = dict(image_height=h, image_width=w, tanfovx=tanf, tanfovy=tanf,
                  sh_degree=1, include_feature=include_feature, tile_size=16,
                  grad_mode="feature" if include_feature else "full")
    common = {"budget": 2048} | common | kw
    return (JaxSettings(backend="tiled", max_per_tile=128, **common),
            RenderSettings(**common))


def warm_leaves(jstate, seed):
    """The optimizer state's leaves with count 5 and moments of a few steps' size."""
    rng = np.random.default_rng(seed)
    out, moments = [], 0
    for x in jax.tree.leaves(jstate):     # per group: count, mu, nu (+ schedule count)
        x = np.asarray(x)
        if x.ndim == 0:
            out.append(np.asarray(5, x.dtype))
            continue
        out.append((1e-3 * rng.normal(size=x.shape)).astype(np.float32) if moments % 2 == 0
                   else rng.uniform(1e-4, 1e-3, size=x.shape).astype(np.float32))
        moments += 1
    return out


def inputs(include_feature, seed, views=V, h=H, w=W):
    vm, pm, cp, _ = batched_cameras(v=views, w=w, h=h)
    rng = np.random.default_rng(seed + 7)
    chans = 3
    gts = rng.uniform(size=(views, chans, h, w)).astype(np.float32)
    if include_feature:
        gts = rng.normal(size=(views, 3, h, w)).astype(np.float32)
        masks = (rng.uniform(size=(views, 1, h, w)) < 0.7).astype(np.float32)
    else:
        masks = np.ones((views, 1, 1, 1), np.float32)
    return dict(viewmats=np.asarray(vm), projmats=np.asarray(pm), campos=np.asarray(cp),
                gts=gts, masks=masks)


def step_case(include_feature, seed, lambda_dssim=0.2, **kw):
    """(spec for the port, JAX inputs) of one training step."""
    params = field_params(seed, include_feature)
    jset, tset = settings_pair(include_feature)
    jopt = jtr.make_optimizer(JaxOptConfig(), 1.0, include_feature)
    jstate0 = jopt.init(jtr.extract_params(jax_field(params), include_feature))
    leaves = warm_leaves(jstate0, seed)
    jstate = jax.tree.unflatten(jax.tree.structure(jstate0),
                                [jnp.asarray(x) for x in leaves])
    spec = dict(params=params, settings=tset, opt_config=OptimizationConfig(),
                opt_leaves=leaves, include_feature=include_feature,
                lambda_dssim=lambda_dssim, bg=np.array([0.1, 0.2, 0.3], np.float32),
                **inputs(include_feature, seed), **kw)
    jin = dict(field=jax_field(params), opt=jopt, state=jstate, settings=jset,
               stats=jdn.DensifyStats.zeros(params["xyz"].shape[0]),
               args=tuple(jnp.asarray(spec[k]) for k in ("viewmats", "projmats",
                                                         "campos", "gts", "masks"))
               + (jnp.asarray(spec["bg"]),))
    return spec, jin


def render_case(include_feature, seed, grad_of, **kw):
    params = field_params(seed, include_feature)
    jset, tset = settings_pair(include_feature, grad_mode="full", **kw)
    rng = np.random.default_rng(seed + 3)
    weights = {"render": rng.normal(size=(3, H, W)).astype(np.float32)}
    if include_feature:
        weights["language_feature_image"] = rng.normal(size=(3, H, W)).astype(np.float32)
    spec = dict(params=params, settings=tset, grad_of=grad_of, weights=weights,
                bg=np.array([0.1, 0.2, 0.3], np.float32), **inputs(include_feature, seed))
    return spec, jset


def densify_case(cap, n, seed, hot, stride=None):
    params = pcd_params(n, cap, seed)
    if stride:        # spread the alive rows over both shards
        perm = (np.arange(cap) * stride) % cap
        params = {k: v[perm] for k, v in params.items()}
    alive = np.where(params["alive"])[0]
    hot_rows = alive[hot] if isinstance(hot, slice) else np.asarray(hot)
    ga = np.zeros(cap, np.float32)
    ga[hot_rows] = 1.0
    stats = [ga, np.ones(cap, np.float32), np.zeros(cap, np.float32)]
    noise = np.asarray(jax.random.normal(jax.random.key(seed), (cap, 2, 3)))
    rule = dict(extent=2.0, grad_threshold=1e-6)
    return dict(params=params, stats=stats, noise=noise, rule=rule)


CASES = {
    "dp_rgb": ("dp_step", lambda: step_case(False, 1, return_grads=True)),
    "dp_feature": ("dp_step", lambda: step_case(True, 2, return_grads=True)),
    "dp_zero2": ("dp_step", lambda: step_case(False, 3, zero2=True)),
    "dp_replicated": ("dp_step", lambda: step_case(False, 3)),
    "spatial": ("spatial_step", lambda: render_case(True, 4, ("xyz", "language_feature"))),
    "depth": ("depth_step", lambda: render_case(True, 5, ("xyz", "language_feature"))),
    "depth_feature": ("depth_feature", lambda: step_case(True, 6)),
    "gauss_1d": ("gauss_step", lambda: step_case(False, 7)),
    "gauss_feature": ("gauss_step", lambda: step_case(True, 8)),
}
CASES_2X2 = {
    "dp_spatial": ("dp_spatial_step", lambda: step_case(False, 9, lambda_dssim=0.0)),
    "gauss_2d": ("gauss_step", lambda: step_case(False, 10, data_axis=True)),
}


def _tiny_budget_case():
    """A budget just under the view's instance count: each shard's half drops."""
    params = field_params(11, n=40, cap=64)
    jset, tset = settings_pair(False, budget=160)
    return dict(params=params, settings=tset, bg=np.zeros(3, np.float32),
                **inputs(False, 11, views=1)), jset


def _tiny_tmax_case():
    params = field_params(12)
    params["scaling"] = params["scaling"].copy()
    params["scaling"][0] = np.log(3.0)
    jset, tset = settings_pair(False, h=48, w=64, budget=4096, max_tiles_per_gaussian=2)
    return dict(params=params, settings=tset, bg=np.zeros(3, np.float32),
                **inputs(False, 12, views=1, h=48, w=64)), jset


VIEWER_SEED = 11
VIEWER = ("connected", "none")

DENSIFY = {"decisions": lambda: densify_case(64, 20, 4, slice(None, None, 2), stride=13),
           "overflow": lambda: densify_case(16, 8, 1, list(range(8)))}


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own limit (the spawned runs have theirs, RUN_TIMEOUT)."""
    def alarm(*_):
        raise TimeoutError(f"the test ran past its {TEST_TIMEOUT} s")
    old = signal.signal(signal.SIGALRM, alarm)
    signal.alarm(TEST_TIMEOUT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def built():
    return ({name: fn() for name, (_, fn) in CASES.items()},
            {name: fn() for name, (_, fn) in CASES_2X2.items()},
            {"budget": _tiny_budget_case(), "tmax": _tiny_tmax_case()},
            {name: fn() for name, fn in DENSIFY.items()})


@pytest.fixture(scope="module")
def two_ranks(built):
    cases, _, growth, dens = built
    tasks = [(CASES[n][0], cases[n][0]) for n in CASES]
    tasks += [("depth_full", growth[k][0]) for k in ("budget", "tmax")]
    tasks += [("densify", dens[k]) for k in DENSIFY]
    tasks += [("viewer_field", {"params": field_params(VIEWER_SEED),
                                "connected": k == "connected"}) for k in VIEWER]
    tasks += [("collectives_check", {})]
    outs = launch.spawn(runner.run, (tasks,), 2, device_type="cpu", threads=1,
                        run_timeout=RUN_TIMEOUT)
    names = list(CASES) + ["full_budget", "full_tmax"] + [f"densify_{k}" for k in DENSIFY] \
        + [f"viewer_{k}" for k in VIEWER] + ["collectives"]
    return [dict(zip(names, o)) for o in outs]


@pytest.fixture(scope="module")
def four_ranks(built):
    _, cases, _, _ = built
    tasks = [(CASES_2X2[n][0], cases[n][0]) for n in CASES_2X2]
    outs = launch.spawn(runner.run, (tasks,), 4, device_type="cpu", threads=1,
                        run_timeout=RUN_TIMEOUT)
    return [dict(zip(CASES_2X2, o)) for o in outs]


def assert_step_matches(port, j, include_feature, loss_rtol=LOSS_RTOL):
    """A port step's output against a JAX step output (field, opt_state, stats, loss)."""
    np.testing.assert_allclose(port["loss"], float(j.loss), rtol=loss_rtol)
    keys = ttr.PARAM_KEYS_FEATURE if include_feature else ttr.PARAM_KEYS_RGB
    for k in keys:
        name = ttr.FIELD_OF[k]
        np.testing.assert_allclose(port["field"][name], np.asarray(getattr(j.field, name)),
                                   atol=OPT_ATOL, err_msg=name)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(j.opt_state)]
    assert len(jleaves) == len(port["opt_leaves"])
    for a, b in zip(port["opt_leaves"], jleaves):
        np.testing.assert_allclose(a, b, atol=OPT_ATOL)
    # the feature phase's statistics feed no densification, and its means2D tap has no
    # gradient in the port's feature grad mode (JAX's tiled backend differentiates it)
    names = ("denom", "max_radii2d") if include_feature else dn_names
    for name in names:
        a = port["stats"][dn_names.index(name)]
        want = np.asarray(getattr(j.stats, name))
        np.testing.assert_allclose(a, want, atol=GRAD_ATOL * max(1.0, np.abs(want).max()),
                                   err_msg=name)


def replicated_equal(outs, name):
    """Every rank returned the same step (replicated state bit-equal)."""
    for o in outs[1:]:
        for k, v in outs[0][name]["field"].items():
            np.testing.assert_array_equal(o[name]["field"][k], v, err_msg=k)
        for a, b in zip(outs[0][name]["opt_leaves"], o[name]["opt_leaves"]):
            np.testing.assert_array_equal(a, b)


def grads_from_moments(old_leaves, new_leaves, include_feature):
    """Each group's gradient from Adam's first moments before and after one update
    (mu' = 0.9 mu + 0.1 g), leaves in the optax order: per sorted label count, mu, nu,
    and xyz's schedule count."""
    labels = sorted(ttr.PARAM_KEYS_FEATURE if include_feature else ttr.PARAM_KEYS_RGB)
    grads, i = {}, 0
    for label in labels:
        grads[label] = (np.asarray(new_leaves[i + 1], np.float64)
                        - 0.9 * np.asarray(old_leaves[i + 1], np.float64)) / 0.1
        i += 4 if label == "xyz" else 3
    return grads


@pytest.mark.parametrize("case", ["dp_rgb", "dp_feature"])
def test_dp_step_matches_jax(built, two_ranks, case):
    from langsplat_tpu.parallel.data_parallel import make_dp_train_step
    spec, jin = built[0][case]
    feat = spec["include_feature"]
    step = make_dp_train_step(jmesh.make_mesh(2), jin["settings"], jin["opt"],
                              include_feature=feat, lambda_dssim=spec["lambda_dssim"])
    j = step(jin["field"], jin["state"], jin["stats"], *jin["args"])
    assert_step_matches(two_ranks[0][case], j, feat)
    replicated_equal(two_ranks, case)
    grads = grads_from_moments(spec["opt_leaves"], jax.tree.leaves(j.opt_state), feat)
    for k, g in two_ranks[0][case]["grads"].items():
        np.testing.assert_allclose(g, grads[k], atol=GRAD_ATOL, err_msg=k)
        assert np.abs(g).max() > 0, k
    assert two_ranks[0][case]["dropped"] == int(j.dropped) == 0


def test_zero2_matches_replicated_and_jax(built, two_ranks):
    from langsplat_tpu.parallel.data_parallel import (make_dp_train_step,
                                                      shard_opt_state)
    spec, jin = built[0]["dp_zero2"]
    z2, rep = two_ranks[0]["dp_zero2"], two_ranks[0]["dp_replicated"]
    np.testing.assert_allclose(z2["loss"], rep["loss"], rtol=1e-6)
    for k, v in rep["field"].items():
        np.testing.assert_allclose(z2["field"][k], v, atol=OPT_ATOL, err_msg=k)
    for a, b in zip(z2["opt_leaves"], rep["opt_leaves"]):
        np.testing.assert_allclose(a, b, atol=OPT_ATOL)
    m = jmesh.make_mesh(2)
    step = make_dp_train_step(m, jin["settings"], jin["opt"], include_feature=False,
                              zero2=True, capacity=32, opt_state_template=jin["state"])
    j = step(jin["field"], shard_opt_state(m, jin["state"], 32), jin["stats"],
             *jin["args"])
    assert_step_matches(z2, j, False)
    replicated_equal(two_ranks, "dp_zero2")


def jax_render_grads(render_fn, spec, jset, names):
    params = spec["params"]
    field = jax_field(params)
    v, p, c = (jnp.asarray(spec[k][0]) for k in ("viewmats", "projmats", "campos"))
    bg = jnp.asarray(spec["bg"])

    def loss(leaves):
        out = render_fn(dataclasses.replace(field, **leaves), v, p, c, bg)
        return sum(jnp.sum(out[k] * jnp.asarray(w)) for k, w in spec["weights"].items()), out
    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(
        {n: getattr(field, n) for n in names})
    return out, grads


def assert_render_matches(port, out, grads):
    for k in ("render", "language_feature_image", "final_transmittance"):
        np.testing.assert_allclose(port[k], np.asarray(out[k]), atol=IMG_ATOL, err_msg=k)
    assert port["instances_dropped"] == int(out["instances_dropped"]) == 0
    for k, g in grads.items():
        np.testing.assert_allclose(port["grads"][k], np.asarray(g), atol=GRAD_ATOL,
                                   err_msg=k)
        assert np.abs(np.asarray(g)).max() > 0, k


def test_spatial_render_and_gradients_match_jax(built, two_ranks):
    from jax.sharding import Mesh
    from langsplat_tpu.parallel.spatial import make_spatial_render
    spec, jset = built[0]["spatial"]
    fn = make_spatial_render(Mesh(np.asarray(jax.devices()[:2]), ("tiles",)), jset,
                             axis="tiles")
    out, grads = jax_render_grads(fn, spec, jset, spec["grad_of"])
    for o in two_ranks:
        assert_render_matches(o["spatial"], out, grads)


def test_depth_render_and_gradients_match_jax(built, two_ranks):
    from langsplat_tpu.parallel.depth_sharded import make_depth_sharded_render
    spec, jset = built[0]["depth"]
    fn = make_depth_sharded_render(jmesh.make_mesh(2, axis_names=("depth",)), jset)
    out, grads = jax_render_grads(fn, spec, jset, spec["grad_of"])
    for o in two_ranks:
        assert_render_matches(o["depth"], out, grads)


def test_depth_feature_step_matches_jax(built, two_ranks):
    from langsplat_tpu.parallel.depth_sharded import make_depth_sharded_feature_step
    spec, jin = built[0]["depth_feature"]
    step = make_depth_sharded_feature_step(jmesh.make_mesh(2, axis_names=("depth",)),
                                           jin["settings"], jin["opt"])
    vm, pm, cp, gts, masks, bg = jin["args"]
    f, state, loss, dropped, _ = step(jin["field"], jin["state"], vm[0], pm[0], cp[0],
                                      gts[0], masks[0], bg)
    port = two_ranks[0]["depth_feature"]
    np.testing.assert_allclose(port["loss"], float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(port["field"]["language_feature"],
                               np.asarray(f.language_feature), atol=OPT_ATOL)
    for a, b in zip(port["opt_leaves"], jax.tree.leaves(state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=OPT_ATOL)
    assert port["dropped"] == int(dropped) == 0
    replicated_equal(two_ranks, "depth_feature")


@pytest.mark.parametrize("case", ["budget", "tmax"])
def test_depth_render_full_grows_like_jax(built, two_ranks, case):
    from langsplat_tpu.parallel.depth_sharded import depth_sharded_render_full
    spec, jset = built[2][case]
    out = depth_sharded_render_full(
        jmesh.make_mesh(2, axis_names=("depth",)), jset, jax_field(spec["params"]),
        *(jnp.asarray(spec[k][0]) for k in ("viewmats", "projmats", "campos")),
        jnp.asarray(spec["bg"]))
    port = two_ranks[0][f"full_{case}"]
    np.testing.assert_allclose(port["render"], np.asarray(out["render"]), atol=IMG_ATOL)
    grown = (port["budget"] > spec["settings"].budget if case == "budget"
             else port["max_tiles"] > spec["settings"].max_tiles_per_gaussian)
    assert grown and int(out["instances_dropped"]) == int(out["rect_dropped"]) == 0


@pytest.mark.parametrize("case", ["gauss_1d", "gauss_feature"])
def test_gauss_step_matches_jax(built, two_ranks, case):
    from langsplat_tpu.parallel.gauss_sharded import (make_gauss_sharded_train_step,
                                                      shard_state)
    spec, jin = built[0][case]
    feat = spec["include_feature"]
    m = jmesh.make_mesh(2, axis_names=("gauss",))
    step = make_gauss_sharded_train_step(m, jin["settings"], jin["opt"], feat, 32,
                                         jin["field"], jin["state"],
                                         lambda_dssim=spec["lambda_dssim"])
    j = step(shard_state(m, jin["field"], 32), shard_state(m, jin["state"], 32),
             shard_state(m, jin["stats"], 32), *jin["args"])
    for o in two_ranks:
        assert_step_matches(o[case], j, feat)


def test_gauss_step_2d_matches_jax(built, four_ranks):
    from langsplat_tpu.parallel.gauss_sharded import (make_gauss_sharded_train_step,
                                                      shard_state)
    spec, jin = built[1]["gauss_2d"]
    m = jmesh.make_mesh(4, axis_names=("data", "gauss"))
    assert dict(zip(m.axis_names, m.devices.shape)) == {"data": 2, "gauss": 2}
    step = make_gauss_sharded_train_step(m, jin["settings"], jin["opt"], False, 32,
                                         jin["field"], jin["state"],
                                         lambda_dssim=spec["lambda_dssim"],
                                         gauss_axis="gauss", data_axis="data")
    j = step(shard_state(m, jin["field"], 32), shard_state(m, jin["state"], 32),
             shard_state(m, jin["stats"], 32), *jin["args"])
    for o in four_ranks:
        assert_step_matches(o["gauss_2d"], j, False)


def test_dp_spatial_step_matches_jax(built, four_ranks):
    from langsplat_tpu.parallel.dp_spatial import make_dp_spatial_train_step
    spec, jin = built[1]["dp_spatial"]
    step = make_dp_spatial_train_step(jmesh.make_mesh(4, axis_names=("data", "tiles")),
                                      jin["settings"], jin["opt"], include_feature=False,
                                      lambda_dssim=0.0)
    j = step(jin["field"], jin["state"], jin["stats"], *jin["args"])
    assert_step_matches(four_ranks[0]["dp_spatial"], j, False)
    replicated_equal(four_ranks, "dp_spatial")


def alive_multiset(field):
    xyz = field["xyz"][field["alive"].astype(bool)]
    return xyz[np.lexsort(xyz.T)]


def jax_densify(spec, sharded: bool):
    from langsplat_tpu.parallel.gauss_densify import make_sharded_densify
    from langsplat_tpu.parallel.gauss_sharded import shard_state
    field = jax_field(spec["params"])
    stats = jdn.DensifyStats(*(jnp.asarray(s) for s in spec["stats"]))
    cap = spec["noise"].shape[0]
    if not sharded:
        return jdn.densify_core(field, stats, jnp.asarray(spec["noise"]), **spec["rule"])
    m = jmesh.make_mesh(2, axis_names=("gauss",))
    fn = make_sharded_densify(m, field, cap, **spec["rule"])
    key = jax.random.key({64: 4, 16: 1}[cap])
    return fn(shard_state(m, field, cap), shard_state(m, stats, cap), key)


def test_sharded_densify_decisions_match_the_serial_rule(built, two_ranks):
    spec = built[3]["decisions"]
    serial = jax_densify(spec, sharded=False)
    port = two_ranks[0]["densify_decisions"]
    assert port["num_alive"] == int(serial.num_alive)
    assert port["overflow"] == int(serial.overflow) == 0
    sfield = {k: np.asarray(getattr(serial.field, k)) for k in ("xyz", "alive")}
    np.testing.assert_allclose(alive_multiset(port["field"]), alive_multiset(sfield),
                               atol=1e-6)
    assert int(port["reset_mask"].sum()) == int(np.asarray(serial.reset_mask).sum())


def test_sharded_densify_overflow_is_conservative(built, two_ranks):
    spec = built[3]["overflow"]
    serial = jax_densify(spec, sharded=False)
    sharded = jax_densify(spec, sharded=True)
    port = two_ranks[0]["densify_overflow"]
    assert int(serial.overflow) == 0 < port["overflow"] == int(sharded.overflow)
    assert port["num_alive"] == int(sharded.num_alive) <= int(serial.num_alive)


@pytest.mark.parametrize("viewer", VIEWER)
def test_gauss_viewer_field_is_gathered_only_while_a_viewer_is_connected(two_ranks,
                                                                         viewer):
    """`Layout.viewer_field` on 2 Gaussian-sharded ranks, rank 0's viewer connected or
    not: every rank joins the all-reduce that says whether one is; while one is, every
    rank joins the gather of each leaf and gets the whole field (rows in `spread_rows`
    order); while none is, no rank gathers, and rank 0 tries to accept a viewer."""
    full = gauss_sharded.spread_rows(from_numpy(field_params(VIEWER_SEED), "cpu"), 32, 2)
    want = {n: getattr(full, n).numpy() for n in FIELD_NAMES
            if getattr(full, n) is not None}
    for r, o in enumerate(two_ranks):
        got = o[f"viewer_{viewer}"]
        if viewer == "connected":
            assert got["gathered"] and got["calls"] == {"max": 1,
                                                        "all_gather_rows": len(want)}, r
            assert sorted(got["field"]) == sorted(want)
            for n, v in want.items():
                np.testing.assert_array_equal(got["field"][n], v, err_msg=n)
        else:
            assert not got["gathered"] and got["calls"] == {"max": 1}, r
        assert got["connect_attempts"] == int(r == 0 and viewer == "none"), r


def test_collectives_match_the_cpu_arithmetic(two_ranks):
    for r, o in enumerate(two_ranks):
        c = o["collectives"]
        assert (c["world"], c["backend"]) == (2, "gloo"), r
        assert max(c["errors"].values()) <= 1e-6, c["errors"]
        # the spawned ranks imported nothing of JAX, the JAX package or the tests
        assert c["foreign_modules"] == [], c["foreign_modules"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
def test_mesh_factorization_matches_jax(n):
    assert mesh.mesh_shape(n, 1) == (n,)
    d0 = mesh.mesh_shape(n, 2)[0]
    # the JAX package's rule (langsplat_tpu/parallel/mesh.py:24-31)
    want = next(c for c in range(int(np.sqrt(n)), 0, -1) if n % c == 0)
    assert mesh.mesh_shape(n, 2) == (want, n // want) and d0 * (n // d0) == n


def test_a_failing_rank_ends_the_run():
    with pytest.raises(launch.RankFailed, match="KeyError: 'no_such_task'"):
        launch.spawn(runner.run, ([("collectives_check", {}), ("no_such_task", {})],),
                     2, device_type="cpu", threads=1, run_timeout=60)


def test_the_rank_that_failed_first_is_named(tmp_path):
    """A rank that raises breaks its peers' collectives, and `join` may meet a peer's
    error first: `spawn` names the rank with the earliest stamped failure instead."""
    for rank, stamp, trace in ((0, 30, "RuntimeError: Connection closed by peer"),
                               (2, 10, "FileNotFoundError: img_002_f.npy"),
                               (3, 20, "RuntimeError: Connection closed by peer")):
        (tmp_path / f"rank{rank}.err").write_text(f"{stamp}\n{trace}")
    (tmp_path / "rank1.pt").write_text("")
    assert launch._first_failure(str(tmp_path)) == (
        "rank 2 raised:\nFileNotFoundError: img_002_f.npy")
    (tmp_path / "none").mkdir()
    assert launch._first_failure(str(tmp_path / "none")) is None


def test_nccl_needs_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--dist_backend gloo"):
        launch.choose_backend("nccl", "cuda", 2)
    with pytest.raises(ValueError, match="--dist_backend gloo"):
        launch.choose_backend("nccl", "cpu", 2)
    assert launch.choose_backend(None, "cpu", 4) == "gloo"
    assert launch.choose_backend(None, "cuda", 1) == "nccl"
    assert launch.choose_backend("gloo", "cuda", 4) == "gloo"
