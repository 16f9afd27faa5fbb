"""Argparse front end over the typed configs.

PyTorch-port counterpart of `langsplat_tpu/cli/args.py`, with the flags the render path
reads: the 3DGS model flags (--source_path/-s, --model_path/-m, --images/-i,
--resolution/-r, --white_background/-w, --feature_level/-f) and the rasterizer's
pipeline flags. The optimization flags come with the training slice.
"""

from __future__ import annotations

import argparse

from langsplat_tpu_torch.config import ModelConfig, PipelineConfig, TrainConfig


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--sh_degree", type=int, default=3)
    p.add_argument("--source_path", "-s", type=str, default="")
    p.add_argument("--model_path", "-m", type=str, default="")
    p.add_argument("--language_features_name", "-l", type=str,
                   default="language_features_dim3")
    p.add_argument("--images", "-i", type=str, default="images")
    p.add_argument("--resolution", "-r", type=int, default=-1)
    p.add_argument("--white_background", "-w", action="store_true")
    p.add_argument("--feature_level", "-f", type=int, default=-1)
    p.add_argument("--eval", action="store_true")


def add_pipeline_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--convert_SHs_python", action="store_true")
    p.add_argument("--compute_cov3D_python", action="store_true")
    p.add_argument("--tile_size", type=int, default=16)
    p.add_argument("--budget_factor", type=int, default=6)
    p.add_argument("--allow_budget_truncation", action="store_true")


def extract_configs(args) -> TrainConfig:
    model = ModelConfig(
        sh_degree=args.sh_degree, source_path=args.source_path,
        model_path=args.model_path,
        language_features_name=args.language_features_name, images=args.images,
        resolution=args.resolution, white_background=args.white_background,
        feature_level=args.feature_level, eval=args.eval)
    pipeline = PipelineConfig(
        convert_shs_python=args.convert_SHs_python,
        compute_cov3d_python=args.compute_cov3D_python,
        tile_size=args.tile_size,
        budget_factor=args.budget_factor,
        allow_budget_truncation=args.allow_budget_truncation)
    return TrainConfig(model=model, pipeline=pipeline)
