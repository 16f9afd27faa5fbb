"""Autoencoder train/test CLIs of the PyTorch port, with the flags of
`langsplat_tpu/cli/autoencoder_cli.py` plus --device:

    python -m langsplat_tpu_torch.cli.autoencoder_cli --dataset_path <scene> \
        --dataset_name <name> [--num_epochs 100] [--device cpu]
    python -m langsplat_tpu_torch.cli.autoencoder_cli test --dataset_path <scene> \
        --dataset_name <name> [--device cpu]

train: every `<scene>/language_features/*_f.npy` row, Adam (optax's defaults) with
batch 64 and loss L2 + 0.001 * cos, the shuffle of `np.random.default_rng(seed)` each
epoch with the tail padded from the permutation's head, and a best-checkpoint eval
((L2 + cos) * rows over batches of 4096, running BatchNorm statistics) on the epochs
after `num_epochs * eval_from_frac`; a run that evaluates nothing saves its final state.
The checkpoint is `<ckpt_root>/<name>/best_ckpt.npz` with the JAX package's leaves, so
either package reads the other's.

test: encode every 512-d feature to 3-d into `<scene>/language_features_dim3/*_f.npy`
and copy the `*_s.npy` segment maps beside them: the targets of training phase B.
Both run on the CUDA card unless --device says otherwise, and fail without a card.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
import time

import numpy as np
import torch

from langsplat_tpu_torch.models.autoencoder import (Autoencoder, ae_loss, cos_loss,
                                                    from_jax_leaves, init_autoencoder,
                                                    l2_loss, to_jax_leaves)
from langsplat_tpu_torch.train.trainer import adam_direction

EVAL_CHUNK = 4096
ADAM_EPS = 1e-8     # optax.adam's default


def load_feature_dataset(data_dir: str):
    """-> (data [N, 512] float32, {file name: row count}) in sorted file order."""
    names = sorted(glob.glob(os.path.join(data_dir, "*f.npy")))
    if not names:
        raise FileNotFoundError(f"no *_f.npy under {data_dir}")
    data_dic = {}
    chunks = []
    for path in names:
        feats = np.load(path)
        data_dic[os.path.basename(path).split(".")[0]] = feats.shape[0]
        chunks.append(feats)
    return np.concatenate(chunks, axis=0).astype(np.float32), data_dic


def save_ae_checkpoint(path: str, model: Autoencoder) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{f"leaf_{i}": x for i, x in enumerate(to_jax_leaves(model))})


def load_ae_checkpoint(path: str, encoder_dims, decoder_dims,
                       input_dim: int = 512) -> Autoencoder:
    """A model (on the CPU) from a checkpoint written by either package."""
    with np.load(path, allow_pickle=False) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    return from_jax_leaves(leaves, encoder_dims, decoder_dims, input_dim)


class TrainStep:
    """One Adam step of the autoencoder on a batch (the BatchNorm layers normalize with
    the batch's statistics and move their running ones); returns the loss tensor. The
    optimizer is optax.adam with its default eps, through the training phases'
    `trainer.adam_direction` over all of the model's tensors at once."""

    def __init__(self, model: Autoencoder, lr: float):
        self.model = model
        self.lr = lr
        self.params = list(model.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.int32, device=self.params[0].device)

    def __call__(self, batch: torch.Tensor) -> torch.Tensor:
        loss = ae_loss(self.model(batch, train=True), batch)
        grads = torch.autograd.grad(loss, self.params)
        with torch.no_grad():
            self.mu, self.nu, self.count, direction = adam_direction(
                grads, self.mu, self.nu, self.count, ADAM_EPS)
            torch._foreach_add_(self.params, torch._foreach_mul(direction, -self.lr))
        return loss.detach()


@torch.no_grad()
def eval_loss_sum(model: Autoencoder, data: torch.Tensor) -> torch.Tensor:
    """Sum over batches of 4096 rows of (L2 + cos) * rows, in float64 (the JAX CLI adds
    the float32 batch values as Python floats)."""
    total = torch.zeros((), dtype=torch.float64, device=data.device)
    for i in range(0, data.shape[0], EVAL_CHUNK):
        batch = data[i:i + EVAL_CHUNK]
        out = model(batch, train=False)
        total = total + ((l2_loss(out, batch) + cos_loss(out, batch))
                         * batch.shape[0]).double()
    return total


def _dims_args(parser):
    parser.add_argument("--encoder_dims", nargs="+", type=int,
                        default=[256, 128, 64, 32, 3])
    parser.add_argument("--decoder_dims", nargs="+", type=int,
                        default=[16, 32, 64, 128, 256, 256, 512])
    parser.add_argument("--ckpt_root", type=str, default="ckpt")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' to run on the "
                             "CPU)")


def train_main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--dataset_name", type=str, required=True)
    parser.add_argument("--num_epochs", type=int, default=100)
    parser.add_argument("--lr", type=float, default=0.0007)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--eval_from_frac", type=float, default=0.95,
                        help="best-ckpt eval starts after this fraction of epochs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--init_ckpt", type=str, default="",
                        help="start from this checkpoint (either package's, e.g. the "
                             "JAX CLI's init saved by --num_epochs 0) instead of the "
                             "seeded init")
    _dims_args(parser)
    args = parser.parse_args(argv)

    from langsplat_tpu_torch.device import float32_matmul_highest, resolve_device
    device = resolve_device(args.device)
    float32_matmul_highest()

    data_np, _ = load_feature_dataset(os.path.join(args.dataset_path, "language_features"))
    n = data_np.shape[0]
    print(f"dataset: {n} features of dim {data_np.shape[1]}")
    data = torch.from_numpy(data_np).to(device)

    if args.init_ckpt:
        model = load_ae_checkpoint(args.init_ckpt, args.encoder_dims, args.decoder_dims,
                                   data.shape[1]).to(device)
    else:
        model = init_autoencoder(torch.Generator().manual_seed(args.seed),
                                 args.encoder_dims, args.decoder_dims,
                                 data.shape[1]).to(device)
    step = TrainStep(model, args.lr)

    bs = args.batch_size
    steps = (n + bs - 1) // bs
    pad = steps * bs - n
    ckpt_path = os.path.join(args.ckpt_root, args.dataset_name, "best_ckpt.npz")
    os.makedirs(os.path.dirname(ckpt_path), exist_ok=True)
    best_eval, best_epoch = float("inf"), -1
    eval_from = int(args.num_epochs * args.eval_from_frac)
    epoch_seconds = []

    np_rng = np.random.default_rng(args.seed)
    for epoch in range(args.num_epochs):
        t0 = time.perf_counter()
        perm = np_rng.permutation(n)
        order = torch.from_numpy(np.concatenate([perm, perm[:pad]]) if pad else perm)
        order = order.to(device)
        epoch_loss = torch.zeros((), dtype=torch.float64, device=device)
        for i in range(steps):
            epoch_loss = epoch_loss + step(data[order[i * bs:(i + 1) * bs]]).double()
        train_loss = float(epoch_loss) / steps
        epoch_seconds.append(time.perf_counter() - t0)
        if epoch % 10 == 0:
            print(f"epoch {epoch}: train_loss={train_loss:.6f}")

        if epoch > eval_from:
            eval_loss = float(eval_loss_sum(model, data)) / n
            print(f"eval_loss:{eval_loss:.8f}")
            if eval_loss < best_eval:
                best_eval, best_epoch = eval_loss, epoch
                save_ae_checkpoint(ckpt_path, model)

    if best_epoch < 0:  # short runs: always save the final state
        save_ae_checkpoint(ckpt_path, model)
    print(f"best_epoch: {best_epoch}")
    print(f"best_loss: {best_eval:.8f}")
    return dict(best_epoch=best_epoch, best_loss=best_eval, epoch_seconds=epoch_seconds,
                steps_per_epoch=steps, rows=n, checkpoint=ckpt_path)


def test_main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--dataset_name", type=str, required=True)
    _dims_args(parser)
    args = parser.parse_args(argv)

    from langsplat_tpu_torch.device import float32_matmul_highest, resolve_device
    device = resolve_device(args.device)
    float32_matmul_highest()

    t0 = time.perf_counter()
    data_dir = os.path.join(args.dataset_path, "language_features")
    output_dir = os.path.join(args.dataset_path, "language_features_dim3")
    os.makedirs(output_dir, exist_ok=True)
    for filename in os.listdir(data_dir):
        if filename.endswith("_s.npy"):
            shutil.copy(os.path.join(data_dir, filename),
                        os.path.join(output_dir, filename))

    data_np, data_dic = load_feature_dataset(data_dir)
    model = load_ae_checkpoint(
        os.path.join(args.ckpt_root, args.dataset_name, "best_ckpt.npz"),
        args.encoder_dims, args.decoder_dims, data_np.shape[1]).to(device)
    data = torch.from_numpy(data_np).to(device)
    with torch.no_grad():
        features = torch.cat([model.encode(data[i:i + EVAL_CHUNK])
                              for i in range(0, data.shape[0], EVAL_CHUNK)]).cpu().numpy()

    start = 0
    for name, count in data_dic.items():
        np.save(os.path.join(output_dir, name), features[start:start + count])
        start += count
    print(f"wrote {len(data_dic)} feature files to {output_dir}")
    return dict(seconds=time.perf_counter() - t0, rows=int(data_np.shape[0]),
                files=len(data_dic))


if __name__ == "__main__":
    if sys.argv[1:2] == ["test"]:
        test_main(sys.argv[2:])
    else:
        train_main(sys.argv[1:])
