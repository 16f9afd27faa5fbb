"""PyTorch port, field creation and densification against the JAX package:
`create_from_pcd`, `grow_capacity`, `compact`; `densify_core` given the same split noise
(clone/split/prune masks, `alive`, `reset_mask` and `overflow` equal exactly, values to
1e-6), `update_stats` and `reset_opacity`; and `densify_and_prune` draws its noise from a
torch.Generator."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.models import gaussian_field as jgf
from langsplat_tpu.train import densify as jdn
from langsplat_tpu_torch.models import gaussian_field as tgf
from langsplat_tpu_torch.models.gaussian_field import FIELD_NAMES, from_numpy
from langsplat_tpu_torch.train import densify as tdn

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 1e-6


def field_params(n_alive, cap, seed, with_feature=True):
    rng = np.random.default_rng(seed)
    params = dict(
        xyz=rng.uniform(-2, 2, (cap, 3)), features_dc=rng.normal(size=(cap, 1, 3)),
        features_rest=0.2 * rng.normal(size=(cap, 3, 3)),
        scaling=np.log(rng.uniform(0.005, 0.08, (cap, 3))),
        rotation=rng.normal(size=(cap, 4)), opacity=rng.normal(-1.0, 2.5, (cap, 1)),
        language_feature=rng.normal(size=(cap, 3)) if with_feature else None)
    params = {k: None if v is None else v.astype(np.float32) for k, v in params.items()}
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n_alive]] = True
    params["alive"] = alive
    return params


def stats_arrays(cap, seed):
    rng = np.random.default_rng(seed)
    denom = rng.integers(0, 5, cap).astype(np.float32)
    return dict(grad_accum=(rng.uniform(0, 4e-4, cap) * denom).astype(np.float32),
                denom=denom, max_radii2d=rng.uniform(0, 40, cap).astype(np.float32))


def jax_field(params):
    return jgf.GaussianField(**{k: None if params[k] is None else jnp.asarray(params[k])
                                for k in FIELD_NAMES})


def assert_fields_equal(t, j, atol=ATOL):
    for name in FIELD_NAMES:
        jv = getattr(j, name)
        if jv is None:
            assert getattr(t, name) is None, name
        elif name == "alive":
            np.testing.assert_array_equal(t.alive.numpy(), np.asarray(jv))
        else:
            np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(jv),
                                       atol=atol, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("n_alive,cap,use_size,threshold", [
    (100, 160, False, 2e-4), (100, 160, True, 2e-4), (148, 150, False, 1e-6)])
def test_densify_core_matches_jax(n_alive, cap, use_size, threshold):
    """The last case has too few free slots: children overflow."""
    params = field_params(n_alive, cap, seed=cap + n_alive)
    stats = stats_arrays(cap, seed=3)
    noise = np.random.default_rng(9).normal(size=(cap, 2, 3)).astype(np.float32)
    kw = dict(extent=2.0, grad_threshold=threshold, percent_dense=0.02, min_opacity=0.05,
              use_size_threshold=use_size, size_threshold=20.0)
    jres = jdn.densify_core(jax_field(params),
                            jdn.DensifyStats(**{k: jnp.asarray(v) for k, v in stats.items()}),
                            jnp.asarray(noise), **kw)
    tres = tdn.densify_core(from_numpy(params, "cpu"),
                            tdn.DensifyStats(**{k: torch.tensor(v) for k, v in stats.items()}),
                            torch.tensor(noise), **kw)
    np.testing.assert_array_equal(tres.reset_mask.numpy(), np.asarray(jres.reset_mask))
    assert int(tres.overflow) == int(jres.overflow)
    assert int(tres.num_alive) == int(jres.num_alive)
    assert_fields_equal(tres.field, jres.field)
    for name in tdn.STAT_NAMES:
        assert float(getattr(tres.stats, name).abs().max()) == 0.0
    # the case exercises clones, splits, prunes (and overflow where there is no room)
    assert 0 < int(tres.num_alive) != n_alive
    assert (int(tres.overflow) > 0) == (cap - n_alive < 20)


def test_densify_and_prune_draws_from_the_generator():
    params = field_params(100, 160, seed=1)
    stats = tdn.DensifyStats(**{k: torch.tensor(v) for k, v in stats_arrays(160, 2).items()})
    field = from_numpy(params, "cpu")

    def run(seed):
        return tdn.densify_and_prune(field, stats, torch.Generator().manual_seed(seed),
                                     extent=2.0, percent_dense=0.02)

    a, b, c = run(4), run(4), run(5)
    assert torch.equal(a.field.xyz, b.field.xyz)
    assert not torch.equal(a.field.xyz, c.field.xyz)       # split children moved
    noise = torch.randn((160, 2, 3), generator=torch.Generator().manual_seed(4))
    ref = tdn.densify_core(field, stats, noise, extent=2.0, percent_dense=0.02)
    assert torch.equal(a.field.xyz, ref.field.xyz)


def test_update_stats_matches_jax():
    cap, rng = 120, np.random.default_rng(6)
    stats = stats_arrays(cap, seed=7)
    grad = rng.normal(size=(cap, 2)).astype(np.float32) * 1e-3
    vis = rng.uniform(size=cap) < 0.7
    radii = rng.integers(0, 50, cap).astype(np.int32)
    j = jdn.update_stats(jdn.DensifyStats(**{k: jnp.asarray(v) for k, v in stats.items()}),
                         jnp.asarray(grad), jnp.asarray(vis), jnp.asarray(radii), 64, 48)
    t = tdn.update_stats(tdn.DensifyStats(**{k: torch.tensor(v) for k, v in stats.items()}),
                         torch.tensor(grad), torch.tensor(vis), torch.tensor(radii), 64, 48)
    for name in tdn.STAT_NAMES:
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   atol=ATOL, rtol=1e-6, err_msg=name)


def test_reset_opacity_matches_jax():
    params = field_params(50, 64, seed=8)
    t = tdn.reset_opacity(from_numpy(params, "cpu"))
    j = jdn.reset_opacity(jax_field(params))
    assert_fields_equal(t, j)
    assert float(t.get_opacity.max()) <= 0.01 + 1e-7


def test_create_grow_compact_match_jax():
    rng = np.random.default_rng(10)
    pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    cols = rng.uniform(size=(50, 3)).astype(np.float32)
    j = jgf.create_from_pcd(pts, cols, sh_degree=2, capacity=75)
    t = tgf.create_from_pcd(pts, cols, sh_degree=2, capacity=75, device="cpu")
    assert_fields_equal(t, j, atol=1e-5)
    assert t.num_alive == 50 and t.capacity == 75 and t.max_sh_degree == 2
    assert_fields_equal(tgf.grow_capacity(t, 90), jgf.grow_capacity(j, 90), atol=1e-5)
    assert tgf.grow_capacity(t, 60) is t
    params = field_params(40, 64, seed=11)
    assert_fields_equal(tgf.compact(from_numpy(params, "cpu")),
                        jgf.compact(jax_field(params)))
