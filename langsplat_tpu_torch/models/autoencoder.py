"""Scene-wise language autoencoder: 512-d CLIP features <-> 3-d latent codes.

PyTorch counterpart of `langsplat_tpu/models/autoencoder.py`, with its layer quirks:
  - encoder: Linear(512, 256), then per stage [BatchNorm(previous output), ReLU, Linear]
    down to 3; the BatchNorm layers are numbered from 1 (`enc_bn_1` follows
    `enc_dense_0`);
  - decoder: Linear(3, 16), then [ReLU, Linear] stages up to 512, no BatchNorm;
  - encode() and decode() divide by (norm + 1e-12);
  - loss: L2 + 0.001 * cosine, the cosine taken over the BATCH axis.

BatchNorm is flax's, not torch's: the batch variance is E[x^2] - E[x]^2 clipped at 0
(biased), the running statistics move by `ra = 0.9 ra + 0.1 batch` and take that biased
variance, and the output is (x - mean) * (rsqrt(var + eps) * scale) + bias.
`torch.nn.BatchNorm1d` keeps the unbiased variance and normalizes in another order, so
the layer is written out here.

The weights cross between the packages as the JAX CLI's checkpoint leaves
(`to_jax_leaves` / `from_jax_leaves`): `jax.tree.flatten` of {"params",
"batch_stats"}, which orders dict keys as sorted strings, kernels stored [in, out].
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

DEFAULT_ENCODER_DIMS = (256, 128, 64, 32, 3)
DEFAULT_DECODER_DIMS = (16, 32, 64, 128, 256, 256, 512)
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5) over the batch axis of [B, C]."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = x.mean(dim=0)
            var = torch.clamp_min((x * x).mean(dim=0) - mean * mean, 0.0)
            with torch.no_grad():
                self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mean)
                self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + BN_EPS) * self.scale) + self.bias


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


class Autoencoder(nn.Module):
    def __init__(self, encoder_dims: Sequence[int] = DEFAULT_ENCODER_DIMS,
                 decoder_dims: Sequence[int] = DEFAULT_DECODER_DIMS, input_dim: int = 512):
        super().__init__()
        encoder_dims, decoder_dims = tuple(encoder_dims), tuple(decoder_dims)
        enc_in = (input_dim,) + encoder_dims[:-1]
        dec_in = (encoder_dims[-1],) + decoder_dims[:-1]
        self.enc_dense = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(enc_in, encoder_dims))
        self.enc_bn = nn.ModuleList(BatchNorm(d) for d in encoder_dims[:-1])
        self.dec_dense = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dec_in, decoder_dims))

    def encode(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i, dense in enumerate(self.enc_dense):
            if i > 0:
                x = torch.relu(self.enc_bn[i - 1](x, train))
            x = dense(x)
        return _unit(x)

    def decode(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train
        for i, dense in enumerate(self.dec_dense):
            if i > 0:
                x = torch.relu(x)
            x = dense(x)
        return _unit(x)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decode(self.encode(x, train=train), train=train)


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def cos_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - mean cosine similarity over the BATCH axis (the reference's dim=0 quirk)."""
    num = torch.sum(pred * target, dim=0)
    den = (torch.linalg.vector_norm(pred, dim=0) * torch.linalg.vector_norm(target, dim=0)
           + 1e-12)
    return 1.0 - torch.mean(num / den)


def ae_loss(pred: torch.Tensor, target: torch.Tensor,
            cos_weight: float = 0.001) -> torch.Tensor:
    return l2_loss(pred, target) + cos_weight * cos_loss(pred, target)


def init_autoencoder(generator: torch.Generator | None = None,
                     encoder_dims: Sequence[int] = DEFAULT_ENCODER_DIMS,
                     decoder_dims: Sequence[int] = DEFAULT_DECODER_DIMS,
                     input_dim: int = 512) -> Autoencoder:
    """A new model with flax's initializers, drawn from `generator`: every Dense kernel
    lecun_normal (a normal truncated at two standard deviations, variance 1 / fan_in
    after the truncation), zero biases, BatchNorm scale 1, bias 0, mean 0, var 1."""
    model = Autoencoder(encoder_dims, decoder_dims, input_dim)
    with torch.no_grad():
        for dense in list(model.enc_dense) + list(model.dec_dense):
            # flax's truncated_normal divides by the std of a unit normal cut at +-2
            std = math.sqrt(1.0 / dense.in_features) / 0.87962566103423978
            nn.init.trunc_normal_(dense.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            dense.bias.zero_()
    return model


def _leaf_refs(model: Autoencoder) -> list[tuple[str, torch.Tensor, bool]]:
    """(path, tensor, stored transposed) in `jax.tree.flatten` order of the flax
    variables {"params", "batch_stats"}: sorted keys at every level."""
    tree: dict[str, dict[str, dict[str, tuple[torch.Tensor, bool]]]] = {
        "batch_stats": {}, "params": {}}
    for i, bn in enumerate(model.enc_bn, start=1):
        tree["batch_stats"][f"enc_bn_{i}"] = {"mean": (bn.mean, False),
                                              "var": (bn.var, False)}
        tree["params"][f"enc_bn_{i}"] = {"bias": (bn.bias, False),
                                         "scale": (bn.scale, False)}
    for prefix, layers in (("enc_dense", model.enc_dense), ("dec_dense", model.dec_dense)):
        for i, dense in enumerate(layers):
            tree["params"][f"{prefix}_{i}"] = {"bias": (dense.bias, False),
                                               "kernel": (dense.weight, True)}
    return [(f"{c}/{layer}/{leaf}", *tree[c][layer][leaf])
            for c in sorted(tree) for layer in sorted(tree[c])
            for leaf in sorted(tree[c][layer])]


def to_jax_leaves(model: Autoencoder) -> list[np.ndarray]:
    """The model's variables as the JAX package's checkpoint leaves (float32 numpy)."""
    return [np.ascontiguousarray((t.T if transposed else t).detach().cpu().numpy(),
                                 dtype=np.float32)
            for _, t, transposed in _leaf_refs(model)]


def from_jax_leaves(leaves: Sequence[np.ndarray],
                    encoder_dims: Sequence[int] = DEFAULT_ENCODER_DIMS,
                    decoder_dims: Sequence[int] = DEFAULT_DECODER_DIMS,
                    input_dim: int = 512) -> Autoencoder:
    """A model (on the CPU) holding the JAX package's checkpoint leaves."""
    model = Autoencoder(encoder_dims, decoder_dims, input_dim)
    refs = _leaf_refs(model)
    if len(leaves) != len(refs):
        raise ValueError(f"expected {len(refs)} autoencoder leaves, got {len(leaves)}")
    with torch.no_grad():
        for (path, t, transposed), leaf in zip(refs, leaves):
            value = torch.tensor(np.asarray(leaf, dtype=np.float32))
            value = value.T if transposed else value
            if value.shape != t.shape:
                raise ValueError(f"{path}: shape {tuple(value.shape)} in the checkpoint, "
                                 f"{tuple(t.shape)} in the model")
            t.copy_(value)
    return model
