"""PyTorch port, autoencoder: the model against flax with the same variables carried
across as checkpoint leaves (outputs 1e-5, gradients 5e-5 of each leaf's largest
value), BatchNorm's running statistics and Adam's parameters after several steps, the
checkpoint file both ways, and the train/test CLIs against the JAX CLIs."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from langsplat_tpu.cli import autoencoder_cli as jcli
from langsplat_tpu.models.autoencoder import ae_loss as jax_ae_loss
from langsplat_tpu.models.autoencoder import init_autoencoder as jax_init
from langsplat_tpu_torch.cli import autoencoder_cli as tcli
from langsplat_tpu_torch.models.autoencoder import (_leaf_refs, ae_loss, from_jax_leaves,
                                                    init_autoencoder, to_jax_leaves)

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 1e-5          # model outputs, float32 products of depth 5-7
GRAD_RTOL = 5e-5     # gradients, relative to each leaf's largest value
# Dense biases that a BatchNorm normalizes away in train mode: their gradient is zero
BIAS_BEFORE_BN = {f"params/enc_dense_{i}/bias" for i in range(4)}


def unit_rows(n, d=512, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def carried():
    """(flax model, flax variables with trained-looking BatchNorm stats, port model)."""
    model, variables = jax_init(jax.random.key(3))
    leaves, treedef = jax.tree.flatten(variables)
    rng = np.random.default_rng(4)
    # move the BatchNorm statistics and affine parameters off their initial values
    leaves = [np.asarray(x) + (0.1 * rng.normal(size=x.shape)).astype(np.float32)
              if x.ndim == 1 else np.asarray(x) for x in leaves]
    leaves[1] = np.abs(leaves[1]) + 0.5       # variances stay positive
    for i in (3, 5, 7):
        leaves[i] = np.abs(leaves[i]) + 0.5
    variables = jax.tree.unflatten(treedef, [jnp.asarray(x) for x in leaves])
    return model, variables, from_jax_leaves(leaves)


def test_leaves_round_trip_in_jax_order(carried):
    _, variables, port = carried
    ours = to_jax_leaves(port)
    theirs = jax.tree.leaves(variables)
    assert len(ours) == len(theirs) == 40
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="expected 40"):
        from_jax_leaves(ours[:-1])


@pytest.mark.parametrize("train", [False, True])
def test_encode_decode_forward_match_flax(carried, train):
    model, variables, _ = carried
    port = from_jax_leaves(jax.tree.leaves(variables))
    x = unit_rows(64, seed=1)
    z = np.asarray(model.apply(variables, x, train=False, method="encode"))
    if train:
        (jz, upd) = model.apply(variables, x, train=True, method="encode",
                                mutable=["batch_stats"])
        jout, _ = model.apply(variables, x, train=True, mutable=["batch_stats"])
        tz = port.encode(torch.from_numpy(x), train=True)
        stats = to_jax_leaves(port)[:8]
        for a, b in zip(stats, jax.tree.leaves(upd["batch_stats"])):
            np.testing.assert_allclose(a, np.asarray(b), atol=ATOL)
        port = from_jax_leaves(jax.tree.leaves(variables))
        tout = port(torch.from_numpy(x), train=True)
    else:
        jz = z
        jout = model.apply(variables, x, train=False)
        tz = port.encode(torch.from_numpy(x))
        tout = port(torch.from_numpy(x))
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=ATOL)
    jdec = model.apply(variables, z, train=False, method="decode")
    tdec = port.decode(torch.tensor(z))
    np.testing.assert_allclose(tdec.detach().numpy(), np.asarray(jdec), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(tdec.detach().numpy(), axis=1), 1.0,
                               rtol=1e-5)


def test_ae_loss_gradients_match_jax_grad(carried):
    model, variables, _ = carried
    port = from_jax_leaves(jax.tree.leaves(variables))
    x = unit_rows(64, seed=2)

    def loss_fn(params):
        out, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                             x, train=True, mutable=["batch_stats"])
        return jax_ae_loss(out, x)

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    xt = torch.from_numpy(x)
    loss = ae_loss(port(xt, train=True), xt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    # the port's gradients in leaf order: the parameters follow the 8 statistics
    refs = _leaf_refs(port)[8:]
    grads = [(t.grad.T if transposed else t.grad).numpy() for _, t, transposed in refs]
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    largest = max(np.abs(g).max() for g in jleaves)
    for (path, _, _), g, jg in zip(refs, grads, jleaves):
        if path in BIAS_BEFORE_BN:
            # exactly zero (the batch mean removes the bias): rounding noise on both sides
            assert np.abs(g).max() <= GRAD_RTOL * largest, path
            continue
        scale = np.abs(jg).max()
        assert scale > 0, path
        assert np.abs(g - jg).max() <= GRAD_RTOL * scale, (path, np.abs(g - jg).max(),
                                                           scale)


def test_training_steps_match_optax():
    """20 Adam steps on the same batches from the same variables. The statistics after
    5 steps within 1e-5 (seen: 1.4e-6, the first layer's running mean; the others
    2e-7); every leaf after 20 within 2e-5 (seen: 1.0e-5, that running mean again; the
    others 1.5e-6), but the four biases that feed a BatchNorm: their gradient is
    rounding noise on both sides, which Adam scales up to steps of lr (seen 1.6e-5
    apart after 20 steps), so they are held to 1e-4."""
    model, variables = jax_init(jax.random.key(5))
    port = from_jax_leaves(jax.tree.leaves(variables))
    tx = optax.adam(7e-4)
    params, bs = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    @jax.jit
    def step(params, bs, opt_state, batch):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": bs}, batch, train=True,
                                   mutable=["batch_stats"])
            return jax_ae_loss(out, batch), upd["batch_stats"]
        (loss, nbs), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        u, nopt = tx.update(g, opt_state, params)
        return optax.apply_updates(params, u), nbs, nopt, loss

    tstep = tcli.TrainStep(port, 7e-4)
    data = unit_rows(20 * 64, seed=6)
    for i in range(20):
        batch = data[i * 64:(i + 1) * 64]
        params, bs, opt_state, jloss = step(params, bs, opt_state, jnp.asarray(batch))
        tloss = tstep(torch.from_numpy(batch))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
        if i == 4:
            for a, b in zip(to_jax_leaves(port)[:8], jax.tree.leaves(bs)):
                np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    theirs = jax.tree.leaves({"params": params, "batch_stats": bs})
    for (path, _, _), a, b in zip(_leaf_refs(port), to_jax_leaves(port), theirs):
        np.testing.assert_allclose(a, np.asarray(b),
                                   atol=1e-4 if path in BIAS_BEFORE_BN else 2e-5,
                                   err_msg=path)


def test_init_draws_flax_distributions():
    """lecun_normal kernels (a normal cut at two standard deviations, variance 1/fan_in),
    zero biases, BatchNorm at identity; the same generator seed gives the same model."""
    a = init_autoencoder(torch.Generator().manual_seed(0))
    b = init_autoencoder(torch.Generator().manual_seed(0))
    for x, y in zip(to_jax_leaves(a), to_jax_leaves(b)):
        np.testing.assert_array_equal(x, y)
    leaves = dict(zip([p for p, _, _ in _leaf_refs(a)], to_jax_leaves(a)))
    k = leaves["params/enc_dense_0/kernel"]             # [512, 256]
    assert abs(k.std() * np.sqrt(512) - 1.0) < 0.02
    assert np.abs(k).max() <= 2 * np.sqrt(1 / 512) / 0.87962566103423978 + 1e-7
    assert not leaves["params/enc_dense_0/bias"].any()
    np.testing.assert_array_equal(leaves["batch_stats/enc_bn_1/var"], 1.0)
    np.testing.assert_array_equal(leaves["params/enc_bn_1/scale"], 1.0)


def write_features(root, counts=(40, 30), seed=7):
    lf = root / "language_features"
    lf.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(counts):
        np.save(lf / f"img_{i}_f.npy", unit_rows(n, seed=seed + i))
        np.save(lf / f"img_{i}_s.npy", rng.integers(-1, n, (4, 6, 8)).astype(np.int32))


def test_checkpoints_cross_load_and_test_cli_matches_jax(tmp_path, carried):
    """The JAX CLI's checkpoint file loads in the port and the port's `test` CLI writes
    what the JAX `test` CLI writes (`_f` within 1e-5, `_s` copied); the port's file loads
    through the JAX package's loader."""
    _, variables, _ = carried
    for side in ("jax", "port"):
        write_features(tmp_path / side)
    jcli.save_ae_checkpoint(str(tmp_path / "ckpt" / "s" / "best_ckpt.npz"), variables)
    args = ["--dataset_name", "s", "--ckpt_root", str(tmp_path / "ckpt")]
    jcli.test_main(["--dataset_path", str(tmp_path / "jax")] + args)
    out = tcli.test_main(["--dataset_path", str(tmp_path / "port"), "--device", "cpu"]
                         + args)
    assert out["rows"] == 70 and out["files"] == 2
    for i in range(2):
        for suffix in ("f", "s"):
            name = f"language_features_dim3/img_{i}_{suffix}.npy"
            a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert a.dtype == b.dtype and a.shape == b.shape
            if suffix == "f":
                np.testing.assert_allclose(a, b, atol=ATOL)
            else:
                np.testing.assert_array_equal(a, b)

    port = tcli.load_ae_checkpoint(str(tmp_path / "ckpt" / "s" / "best_ckpt.npz"),
                                   [256, 128, 64, 32, 3], [16, 32, 64, 128, 256, 256, 512])
    path = str(tmp_path / "port.npz")
    tcli.save_ae_checkpoint(path, port)
    model, template = jax_init(jax.random.key(0))
    loaded = jcli.load_ae_checkpoint(path, template)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_cli_on_the_cpu(tmp_path):
    """Two epochs of the port's train CLI (batch 16, the tail padded): the loss falls,
    the best-checkpoint eval runs from epoch 1, and its file loads through the JAX
    loader and encodes there as the port encodes."""
    write_features(tmp_path / "scene", counts=(50, 27))
    out = tcli.train_main(["--dataset_path", str(tmp_path / "scene"), "--dataset_name",
                           "t", "--num_epochs", "3", "--batch_size", "16",
                           "--eval_from_frac", "0", "--ckpt_root",
                           str(tmp_path / "ckpt"), "--device", "cpu"])
    assert out["steps_per_epoch"] == 5 and out["rows"] == 77
    assert out["best_epoch"] in (1, 2) and np.isfinite(out["best_loss"])
    model, template = jax_init(jax.random.key(0))
    variables = jcli.load_ae_checkpoint(out["checkpoint"], template)
    port = tcli.load_ae_checkpoint(out["checkpoint"], [256, 128, 64, 32, 3],
                                   [16, 32, 64, 128, 256, 256, 512])
    x = unit_rows(32, seed=9)
    np.testing.assert_allclose(
        port.encode(torch.from_numpy(x)).detach().numpy(),
        np.asarray(model.apply(variables, x, method="encode")), atol=ATOL)


def test_ae_clis_need_a_card_unless_asked(tmp_path, monkeypatch):
    write_features(tmp_path / "scene")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, extra in ((tcli.train_main, []), (tcli.test_main, [])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--dataset_path", str(tmp_path / "scene"), "--dataset_name", "t",
                  "--ckpt_root", str(tmp_path / "ckpt")] + extra)
    assert not os.path.exists(tmp_path / "ckpt")
