"""Typed configuration dataclasses and the run-config file reader and writer.

PyTorch-port counterpart of `langsplat_tpu/config.py`: the same parameter names and
defaults, so a run config (`cfg_args.json`) written by either package loads in the
other. A key this package has no use for (the Pallas chunk) is not a field here and is
ignored when a file holds it. `interpret` selects the tiled backend, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field


@dataclass
class ModelConfig:
    """Mirrors the reference ModelParams."""
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    language_features_name: str = "language_features_dim3"
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    feature_level: int = -1
    eval: bool = False

    @property
    def lf_path(self) -> str:
        return os.path.join(self.source_path, self.language_features_name)


@dataclass
class PipelineConfig:
    """Mirrors the reference PipelineParams plus the rasterizer's instance caps."""
    convert_shs_python: bool = False   # model-layer SH->color cross-check path
    compute_cov3d_python: bool = False  # model-layer covariance cross-check path
    tile_size: int = 16
    budget_factor: int = 6             # instance budget CAP = factor * capacity
    adaptive_budget: bool = True       # size the budget from measured instance counts
    budget_headroom: float = 1.3       # measured count -> budget multiplier
    max_tiles_per_gaussian: int = 32
    allow_budget_truncation: bool = False  # opt-in: proceed (with a warning) when
                                           # the instance budget cap is hit instead
                                           # of failing loudly
    debug: bool = False                # per-step budget/drop diagnostics
    interpret: bool = False            # blend with the tiled backend (ops/rasterize_tiled)
    # multi-device training, one process per rank (parallel/): phase-B depth shards,
    # data-parallel ranks (views a rank a step; ZeRO-2 optimizer rows), Gaussian shards
    depth_shards: int = 0
    data_shards: int = 0
    gauss_shards: int = 0
    zero2: bool = False
    dp_views_per_device: int = 1


@dataclass
class OptimizationConfig:
    """Mirrors the reference OptimizationParams plus the capacity management of a
    fixed-capacity field."""
    iterations: int = 30_000
    position_lr_init: float = 0.000_16
    position_lr_final: float = 0.000_001_6
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    language_feature_lr: float = 0.0025
    include_feature: bool = True
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    # densification works inside a fixed alive-masked capacity, grown geometrically
    # when densification overflows it
    initial_capacity_factor: float = 1.5
    capacity_growth_factor: float = 1.5


@dataclass
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    test_iterations: tuple = (7_000, 30_000)
    save_iterations: tuple = (7_000, 30_000)
    checkpoint_iterations: tuple = (7_000, 30_000)
    start_checkpoint: str = ""
    seed: int = 0
    quiet: bool = False
    # torch.profiler trace window: iterations [profile_from, profile_from +
    # profile_steps) are written to profile_dir
    profile_dir: str = ""
    profile_from: int = 50
    profile_steps: int = 5


_SECTIONS = {"model": ModelConfig, "pipeline": PipelineConfig,
             "optimization": OptimizationConfig}


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _SECTIONS:
            kwargs[f.name] = _from_dict(_SECTIONS[f.name], v)
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2, default=list)


def load_config(path: str) -> TrainConfig:
    with open(path) as f:
        return _from_dict(TrainConfig, json.load(f))
