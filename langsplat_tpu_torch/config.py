"""Typed configuration dataclasses and the run-config file reader.

PyTorch-port counterpart of `langsplat_tpu/config.py`: the same parameter names and
defaults, so a run config (`cfg_args.json`) written by the JAX package loads here.
Keys this package does not use yet (training) or at all (Pallas chunking, interpret
mode, device meshes, profiling) are not fields here and are ignored when a file holds
them.
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


@dataclass
class TrainConfig:
    """The run config's model and pipeline sections (the optimization section and the
    training schedule come with the training slice)."""
    model: ModelConfig = field(default_factory=ModelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)


_SECTIONS = {"model": ModelConfig, "pipeline": PipelineConfig}


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        kwargs[f.name] = _from_dict(_SECTIONS[f.name], v) if f.name in _SECTIONS else v
    return cls(**kwargs)


def load_config(path: str) -> TrainConfig:
    with open(path) as f:
        return _from_dict(TrainConfig, json.load(f))
