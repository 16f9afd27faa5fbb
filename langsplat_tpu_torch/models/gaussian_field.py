"""GaussianField: the scene's Gaussian parameters in fixed-capacity tensors.

PyTorch counterpart of `langsplat_tpu/models/gaussian_field.py:33`, with the same layout
so that fields, checkpoints and PLY files map row for row onto the JAX package:
  - xyz [cap,3]; features_dc [cap,1,3]; features_rest [cap,(K-1),3] (K=(deg+1)^2);
    scaling [cap,3] in log space; rotation [cap,4] unnormalized (w,x,y,z);
    opacity [cap,1] as logits; language_feature [cap,F] or None; alive [cap] bool;
  - activations exp / normalize / sigmoid.
A dataclass of tensors: the render slice only reads it. `create_from_pcd` and the
training-time operations come with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from langsplat_tpu_torch.core import transforms

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
                              seed: int = 0) -> "GaussianField":
        """Attach a small random language feature table (the phase handoff; the JAX
        package's departure from a zero init, for the same reason: the rendered
        features are L2-normalized, and that has a ~1/eps Jacobian at exactly zero).
        The values come from a seeded torch.Generator, so they differ from the JAX
        package's jax.random draw."""
        if self.language_feature is not None:
            return self
        gen = torch.Generator().manual_seed(seed)
        lf = init_scale * torch.randn((self.capacity, num_feat), generator=gen,
                                      dtype=self.xyz.dtype)
        return replace(self, language_feature=lf.to(self.device))

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
