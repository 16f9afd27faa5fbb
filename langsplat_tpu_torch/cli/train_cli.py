"""Training CLI of the PyTorch port, with the flags of `langsplat_tpu/cli/train_cli.py`
plus --device:

    python -m langsplat_tpu_torch.cli.train_cli -s <scene> -m out --no_include_feature
    python -m langsplat_tpu_torch.cli.train_cli -s <scene> -m out --feature_level 3 \
        --start_checkpoint out_-1/chkpnt30000.npz

The first line trains phase A (RGB 3DGS), the second phase B (language features) from
a phase-A checkpoint of either package. The model path is suffixed with the feature
level, as in the reference. It trains on the CUDA card unless --device says otherwise,
and fails without a card. --port serves the SIBR viewer on --ip; --profile_dir writes a
torch.profiler trace of iterations --profile_from .. + --profile_steps - 1.

A multi-device run (--data_shards, --gauss_shards, or --depth_shards in phase B) starts
its ranks itself, one process each (`parallel/launch.py`: rank r on cuda:{r % cards}, or
the CPU with --device cpu, NCCL or --dist_backend gloo), and returns rank 0's result with
every rank's record under "ranks" (the optimizer state and statistics are in the
checkpoints). Under torchrun (RANK and WORLD_SIZE set) each process
is one rank:

    torchrun --nproc_per_node 4 -m langsplat_tpu_torch.cli.train_cli ... --data_shards 4
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

import torch

from langsplat_tpu_torch.cli.args import (add_model_args, add_optimization_args,
                                          add_pipeline_args, extract_configs)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="langsplat_tpu_torch training")
    add_model_args(parser)
    add_optimization_args(parser)
    add_pipeline_args(parser)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--start_checkpoint", type=str, default="")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0,
                        help="SIBR viewer bridge port (0 = disabled)")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="write a torch.profiler trace of a few steps here")
    parser.add_argument("--profile_from", type=int, default=50)
    parser.add_argument("--profile_steps", type=int, default=5)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to train on (default: the CUDA card; 'cpu' "
                             "runs the plain PyTorch blend)")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                        help="process-group backend of a multi-device run (default: "
                             "nccl on CUDA, one card a rank; gloo on the CPU, or for "
                             "ranks that share a card)")
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)

    import torch.distributed as dist

    from langsplat_tpu_torch.device import resolve_device
    from langsplat_tpu_torch.parallel import launch
    from langsplat_tpu_torch.parallel.layout import world_size
    from langsplat_tpu_torch.train.loop import training

    device = resolve_device(args.device)
    cfg = extract_configs(args)
    world = world_size(cfg.pipeline, cfg.optimization.include_feature)
    if world > 1 and not dist.is_initialized():
        if not launch.under_torchrun():
            return _spawned(sys.argv[1:] if argv is None else argv, world, device,
                            args.dist_backend)
        device = launch.init_from_env(args.dist_backend, device.type)
        try:
            return main(argv)
        finally:
            dist.destroy_process_group()
    if dist.is_initialized() and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    if cfg.model.model_path:
        cfg.model.model_path = f"{cfg.model.model_path}_{cfg.model.feature_level}"
    if main_rank:
        print(f"Optimizing {cfg.model.model_path}")
    cfg = replace(cfg, test_iterations=tuple(args.test_iterations),
                  save_iterations=tuple(args.save_iterations),
                  checkpoint_iterations=tuple(args.checkpoint_iterations),
                  start_checkpoint=args.start_checkpoint, seed=args.seed,
                  quiet=args.quiet, profile_dir=args.profile_dir,
                  profile_from=args.profile_from, profile_steps=args.profile_steps)
    result = training(cfg, device=device, gui_host=args.ip, gui_port=args.port)
    if main_rank:
        print("\nTraining complete.")
    return result


def _spawned(argv, world: int, device, backend) -> dict:
    """Run `main(argv)` on `world` spawned ranks; rank 0's result, with every rank's
    `parallel` record under "ranks"."""
    from langsplat_tpu_torch.parallel import launch

    results = launch.spawn(rank_main, (list(argv),), world, device_type=device.type,
                           backend=backend)
    result = results[0]
    result["ranks"] = [r["parallel"] for r in results]
    return result


def rank_main(argv) -> dict:
    """One spawned rank of a multi-device run: rank 0 returns its field, history and
    records on the CPU (the optimizer state and statistics are in its checkpoints), the
    others their `parallel` record."""
    import torch.distributed as dist

    from langsplat_tpu_torch.parallel.gauss_sharded import map_rows

    result = main(argv)
    if dist.get_rank() != 0:
        return {"parallel": result["parallel"]}
    for key in ("scene", "opt_state", "stats"):
        result.pop(key)
    return map_rows(result, None, lambda t: t.cpu())


if __name__ == "__main__":
    main(sys.argv[1:])
