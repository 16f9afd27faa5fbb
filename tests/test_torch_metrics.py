"""PyTorch port, image metrics (`utils/metrics.py`): `normalize_tensor`, `lpips_distance`
and `scale_image_for_lpips` within 1e-6 of the JAX package's on the same seeded inputs;
`load_richzhang_lin` on a `.pth` state dict and on an npz equal to JAX's; the LPIPS
class's gates (no torchvision; no lin weights without `allow_uniform_lin`)."""

import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.utils import metrics as jm
from langsplat_tpu_torch.core import losses
from langsplat_tpu_torch.utils import metrics as tm

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

TOL = 1e-6
ALEX_CHANNELS = (64, 192, 384, 256, 256)
ALEX_SIZES = ((15, 11), (7, 5), (3, 2), (3, 2), (3, 2))   # layer outputs of a ~64x48 image


def layer_features(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(c, h, w)).astype(np.float32)
            for c, (h, w) in zip(ALEX_CHANNELS, ALEX_SIZES)]


def test_functions_match_jax():
    fa, fb = layer_features(0), layer_features(1)
    rng = np.random.default_rng(2)
    # some negative lin weights: both clip them to 0
    lin = [rng.uniform(-0.2, 1.0, size=c).astype(np.float32) for c in ALEX_CHANNELS]
    for a in fa:
        np.testing.assert_allclose(tm.normalize_tensor(torch.tensor(a)).numpy(),
                                   np.asarray(jm.normalize_tensor(jnp.asarray(a))),
                                   atol=TOL)
    want = float(jm.lpips_distance([jnp.asarray(x) for x in fa],
                                   [jnp.asarray(x) for x in fb],
                                   [jnp.asarray(x) for x in lin]))
    got = tm.lpips_distance([torch.tensor(x) for x in fa], [torch.tensor(x) for x in fb],
                            [torch.tensor(x) for x in lin])
    assert got.dim() == 0 and want > 0.1
    assert abs(float(got) - want) <= TOL
    assert float(tm.lpips_distance([torch.tensor(x) for x in fa],
                                   [torch.tensor(x) for x in fa],
                                   [torch.tensor(x) for x in lin])) < 1e-10
    image = rng.uniform(size=(3, 48, 64)).astype(np.float32)
    np.testing.assert_allclose(tm.scale_image_for_lpips(torch.tensor(image)).numpy(),
                               np.asarray(jm.scale_image_for_lpips(jnp.asarray(image))),
                               atol=TOL)
    assert tm.psnr is losses.psnr and tm.ssim is losses.ssim


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_load_richzhang_lin_matches_jax(tmp_path, suffix):
    rng = np.random.default_rng(3)
    weights = [rng.uniform(size=(1, c, 1, 1)).astype(np.float32) for c in ALEX_CHANNELS]
    path = str(tmp_path / f"alex{suffix}")
    if suffix == ".pth":
        sd = {f"lin{i}.model.1.weight": torch.tensor(w) for i, w in enumerate(weights)}
        # reversed insertion order: the loader must sort by layer
        torch.save({k: sd[k] for k in reversed(list(sd))}, path)
    else:
        np.savez(path, **{f"lin{i}": w.reshape(-1) for i, w in enumerate(weights)})
    got, want = tm.load_richzhang_lin(path), jm.load_richzhang_lin(path)
    assert len(got) == len(want) == len(ALEX_CHANNELS)
    for g, w, ref in zip(got, want, weights):
        assert g.dtype == torch.float32 and g.shape == (ref.size,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), ref.reshape(-1))
    if suffix == ".pth":
        torch.save({}, str(tmp_path / "empty.pth"))
        with pytest.raises(ValueError, match="no lin weights"):
            tm.load_richzhang_lin(str(tmp_path / "empty.pth"))


def test_lpips_needs_torchvision(monkeypatch):
    monkeypatch.setitem(sys.modules, "torchvision", None)     # import fails
    monkeypatch.setitem(sys.modules, "torchvision.models", None)
    with pytest.raises(RuntimeError, match="torchvision"):
        tm.LPIPS("alex", device="cpu")


def test_lpips_refuses_uniform_lin_unless_asked():
    """Without lin weights the metric is not LPIPS: refused, or with the opt-in the
    unweighted distance of the JAX package's uniform fallback (features stubbed: the
    backbone's weights are not in the repository)."""
    fa, fb = layer_features(4), layer_features(5)
    lp = tm.LPIPS.__new__(tm.LPIPS)
    lp.lin, lp.allow_uniform_lin = None, False
    lp.extract = lambda image: [torch.tensor(x) for x in (fa if image == "a" else fb)]
    with pytest.raises(RuntimeError, match="no lin weights"):
        lp("a", "b")
    lp.allow_uniform_lin = True
    with pytest.warns(UserWarning, match="UNIFORM"):
        got = lp("a", "b")
    want = float(jm.lpips_distance([jnp.asarray(x) for x in fa],
                                   [jnp.asarray(x) for x in fb],
                                   [jnp.ones(c) / c for c in ALEX_CHANNELS]))
    assert abs(got - want) <= TOL
