"""GaussianField: the scene's Gaussian parameters in fixed-capacity tensors.

PyTorch counterpart of `langsplat_tpu/models/gaussian_field.py:33`, with the same layout
so that fields, checkpoints and PLY files map row for row onto the JAX package:
  - xyz [cap,3]; features_dc [cap,1,3]; features_rest [cap,(K-1),3] (K=(deg+1)^2);
    scaling [cap,3] in log space; rotation [cap,4] unnormalized (w,x,y,z);
    opacity [cap,1] as logits; language_feature [cap,F] or None; alive [cap] bool;
  - activations exp / normalize / sigmoid;
  - creation from a point cloud: RGB->SH DC init, log of the mean 3-NN distance as the
    scales, identity quaternions, opacity 0.1, dead padding slots up to the capacity.
A dataclass of tensors. Training replaces its tensors out of place (new dataclass
instances), as the JAX package's immutable pytrees do.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from langsplat_tpu_torch.core import sh as sh_lib
from langsplat_tpu_torch.core import transforms
from langsplat_tpu_torch.ops.knn import mean_knn_sq_dist

#: field names in the JAX GaussianField's declaration order
FIELD_NAMES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity",
               "language_feature", "alive")


@dataclass
class GaussianField:
    xyz: torch.Tensor                 # [cap, 3]
    features_dc: torch.Tensor         # [cap, 1, 3]
    features_rest: torch.Tensor       # [cap, K-1, 3]
    scaling: torch.Tensor             # [cap, 3] log-scales
    rotation: torch.Tensor            # [cap, 4] quaternions (w,x,y,z), unnormalized
    opacity: torch.Tensor             # [cap, 1] logits
    language_feature: torch.Tensor | None  # [cap, F] or None (RGB phase)
    alive: torch.Tensor               # [cap] bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return self.rotation / (torch.linalg.vector_norm(self.rotation, dim=-1,
                                                         keepdim=True) + 1e-12)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:  # [cap, K, 3]
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    @property
    def get_language_feature(self) -> torch.Tensor:
        if self.language_feature is None:
            raise ValueError("language feature not initialized (RGB phase field)")
        return self.language_feature

    def get_covariance(self, scale_modifier: float = 1.0) -> torch.Tensor:
        """[cap, 6] packed symmetric covariance."""
        cov = transforms.build_covariance_3d(self.get_scaling, self.rotation,
                                             scale_modifier)
        return transforms.strip_symmetric(cov)

    @property
    def max_sh_degree(self) -> int:
        k = 1 + self.features_rest.shape[1]
        return int(round(np.sqrt(k))) - 1

    def with_language_feature(self, num_feat: int = 3, init_scale: float = 1e-2,
                              generator: torch.Generator | None = None,
                              table: torch.Tensor | None = None) -> "GaussianField":
        """Attach a small random language feature table (the phase handoff; the JAX
        package's departure from a zero init, for the same reason: the rendered
        features are L2-normalized, and that has a ~1/eps Jacobian at exactly zero).

        The caller gives the randomness: `table` [capacity, num_feat] as it is, or
        init_scale * N(0, 1) drawn from `generator` (a CPU torch.Generator; a fresh
        unseeded one if None). A torch.Generator does not give the JAX package's
        jax.random numbers, so tests hand both packages the same table."""
        if self.language_feature is not None:
            return self
        if table is None:
            table = init_scale * torch.randn((self.capacity, num_feat),
                                             generator=generator, dtype=self.xyz.dtype)
        if tuple(table.shape) != (self.capacity, num_feat):
            raise ValueError(f"language feature table {tuple(table.shape)} != "
                             f"{(self.capacity, num_feat)}")
        return replace(self, language_feature=table.to(self.device, self.xyz.dtype))

    def to(self, device: str | torch.device) -> "GaussianField":
        return GaussianField(**{f.name: None if getattr(self, f.name) is None
                                else getattr(self, f.name).to(device)
                                for f in fields(self)})


def from_numpy(params: dict[str, np.ndarray], device: str | torch.device) -> GaussianField:
    """A field from the JAX GaussianField's leaves, keyed by field name
    (`language_feature` may be missing or None)."""
    def tensor(name, dtype):
        value = params.get(name)
        return None if value is None else torch.as_tensor(
            np.asarray(value), dtype=dtype, device=device)

    return GaussianField(**{name: tensor(name, torch.bool if name == "alive"
                                         else torch.float32)
                            for name in FIELD_NAMES})


def create_from_pcd(points: np.ndarray, colors: np.ndarray, *, sh_degree: int,
                    device: str | torch.device, capacity: int | None = None
                    ) -> GaussianField:
    """A field from an SfM point cloud (`langsplat_tpu/models/gaussian_field.py:104`):
    DC from the colours, log-scales from the mean squared distance to the 3 nearest
    neighbours, identity rotations, opacity 0.1; slots past the points are dead, with
    log-scale and opacity logit -10."""
    n = points.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    k = (sh_degree + 1) ** 2
    pts = torch.as_tensor(np.asarray(points), dtype=torch.float32, device=device)
    dist2 = torch.clamp_min(mean_knn_sq_dist(pts), 1e-7)
    log_scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def padded(x, fill=0.0):
        full = torch.full((cap,) + tuple(x.shape[1:]), fill, dtype=torch.float32,
                          device=device)
        full[:n] = x
        return full

    dc = sh_lib.rgb_to_sh(torch.as_tensor(np.asarray(colors), dtype=torch.float32,
                                          device=device))[:, None, :]
    rotation = torch.zeros((cap, 4), dtype=torch.float32, device=device)
    rotation[:, 0] = 1.0
    opacity = transforms.inverse_sigmoid(torch.full((n, 1), 0.1, device=device))
    return GaussianField(
        xyz=padded(pts), features_dc=padded(dc),
        features_rest=torch.zeros((cap, k - 1, 3), dtype=torch.float32, device=device),
        scaling=padded(log_scales, fill=-10.0), rotation=rotation,
        opacity=padded(opacity, fill=-10.0), language_feature=None,
        alive=torch.arange(cap, device=device) < n)


def grow_capacity(field: GaussianField, new_capacity: int) -> GaussianField:
    """Pad every tensor to a larger capacity with dead slots."""
    cap = field.capacity
    if new_capacity <= cap:
        return field
    extra = new_capacity - cap

    def pad(x, fill=0.0):
        if x is None:
            return None
        block = torch.full((extra,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                           device=x.device)
        return torch.cat([x, block], dim=0)

    rotation = pad(field.rotation)
    rotation[cap:, 0] = 1.0
    return GaussianField(
        xyz=pad(field.xyz), features_dc=pad(field.features_dc),
        features_rest=pad(field.features_rest), scaling=pad(field.scaling, -10.0),
        rotation=rotation, opacity=pad(field.opacity, -10.0),
        language_feature=pad(field.language_feature), alive=pad(field.alive, False))


def compact(field: GaussianField) -> GaussianField:
    """Move the alive Gaussians to the front, in their order."""
    order = torch.sort((~field.alive).to(torch.int8), stable=True).indices
    return GaussianField(**{f.name: None if getattr(field, f.name) is None
                            else getattr(field, f.name)[order] for f in fields(field)})
