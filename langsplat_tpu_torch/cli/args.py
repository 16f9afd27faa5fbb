"""Argparse front end over the typed configs.

PyTorch-port counterpart of `langsplat_tpu/cli/args.py`, with the same flags: the 3DGS
model flags (--source_path/-s, --model_path/-m, --images/-i, --resolution/-r,
--white_background/-w, --feature_level/-f), the rasterizer's pipeline flags and the
optimization flags. --interpret selects the tiled backend (`ops/rasterize_tiled.py`) on
the device asked, as in the JAX package. The multi-device flags (--data_shards, --zero2,
--dp_views_per_device, --gauss_shards, --depth_shards) are the training CLI's: it runs
one process per rank (`parallel/launch.py`). The JAX package's flag that the port has no
counterpart for (--chunk, the TPU's Pallas block) is accepted and refused with an error
that names it, rather than ignored.
"""

from __future__ import annotations

import argparse

from langsplat_tpu_torch.config import (ModelConfig, OptimizationConfig, PipelineConfig,
                                        TrainConfig)


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
    p.add_argument("--debug", action="store_true")
    p.add_argument("--chunk", type=int, default=None,
                   help="the JAX package's Pallas chunk: refused (the port's kernels "
                        "take none)")
    p.add_argument("--interpret", action="store_true",
                   help="blend with the tiled backend (plain PyTorch, at most 1024 "
                        "instances a tile) on the device asked")
    p.add_argument("--depth_shards", type=int, default=0,
                   help="phase B over this many ranks, each blending one interval of "
                        "the depth order (parallel/depth_sharded.py)")
    p.add_argument("--data_shards", type=int, default=0,
                   help="train data-parallel over this many ranks (parallel/"
                        "data_parallel.py); 1 with --dp_views_per_device > 1 trains "
                        "that view batch in one process")
    p.add_argument("--gauss_shards", type=int, default=0,
                   help="split the Gaussians' rows and the image's tile bands over this "
                        "many ranks (parallel/gauss_sharded.py)")
    p.add_argument("--zero2", action="store_true",
                   help="with --data_shards: split the Adam moments by rows")
    p.add_argument("--dp_views_per_device", type=int, default=1,
                   help="with --data_shards: views a rank renders a step")


def add_optimization_args(p: argparse.ArgumentParser) -> None:
    d = OptimizationConfig()
    for name in ("iterations", "position_lr_init", "position_lr_final",
                 "position_lr_delay_mult", "position_lr_max_steps", "feature_lr",
                 "opacity_lr", "language_feature_lr"):
        p.add_argument(f"--{name}", type=type(getattr(d, name)), default=getattr(d, name))
    p.add_argument("--include_feature", action="store_true", default=d.include_feature)
    p.add_argument("--no_include_feature", dest="include_feature", action="store_false",
                   help="train the original 3DGS (phase A)")
    for name in ("scaling_lr", "rotation_lr", "percent_dense", "lambda_dssim",
                 "densification_interval", "opacity_reset_interval",
                 "densify_from_iter", "densify_until_iter", "densify_grad_threshold",
                 "initial_capacity_factor", "capacity_growth_factor"):
        p.add_argument(f"--{name}", type=type(getattr(d, name)), default=getattr(d, name))


def refuse_unported(args) -> None:
    """Raise for the flag of the JAX package that the port does not honour."""
    if args.chunk is not None:
        raise NotImplementedError(f"options of the JAX package not ported yet: --chunk "
                                  f"{args.chunk} (the JAX package's Pallas chunk)")


def extract_configs(args) -> TrainConfig:
    refuse_unported(args)
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
        allow_budget_truncation=args.allow_budget_truncation,
        **{name: getattr(args, name) for name in (
            "debug", "interpret", "depth_shards", "data_shards", "gauss_shards", "zero2",
            "dp_views_per_device")})
    optimization = OptimizationConfig(**{
        f: getattr(args, f) for f in OptimizationConfig.__dataclass_fields__
        if hasattr(args, f)})
    return TrainConfig(model=model, pipeline=pipeline, optimization=optimization)
