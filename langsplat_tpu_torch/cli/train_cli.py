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
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

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
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)

    from langsplat_tpu_torch.device import resolve_device
    from langsplat_tpu_torch.train.loop import training

    device = resolve_device(args.device)
    cfg = extract_configs(args)
    if cfg.model.model_path:
        cfg.model.model_path = f"{cfg.model.model_path}_{cfg.model.feature_level}"
    print(f"Optimizing {cfg.model.model_path}")
    cfg = replace(cfg, test_iterations=tuple(args.test_iterations),
                  save_iterations=tuple(args.save_iterations),
                  checkpoint_iterations=tuple(args.checkpoint_iterations),
                  start_checkpoint=args.start_checkpoint, seed=args.seed,
                  quiet=args.quiet, profile_dir=args.profile_dir,
                  profile_from=args.profile_from, profile_steps=args.profile_steps)
    result = training(cfg, device=device, gui_host=args.ip, gui_port=args.port)
    print("\nTraining complete.")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
