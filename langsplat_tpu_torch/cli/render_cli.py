"""Render CLI: render a trained scene's views with the PyTorch port.

    python -m langsplat_tpu_torch.cli.render_cli -m <model> -s <scene> \
        [--include_feature] [--device cpu]

Writes the same tree as `langsplat_tpu/cli/render_cli.py`: per view,
`<model>/<split>/ours_<iter>/renders/<idx>.png` and `renders_npy/<idx>.npy` (H, W, C),
plus the ground truth under `gt/` and `gt_npy/`. The .npy files are the eval pipeline's
input. With --include_feature the output is the language feature image, read from the
iteration's `chkpnt<iter>.npz`, and the ground truth is the camera's language feature.
It runs on the CUDA card unless --device says otherwise, and fails without a card;
--interpret blends with the tiled backend (`ops/rasterize_tiled.py`) instead of the
kernels.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from langsplat_tpu_torch.cli.args import add_model_args, add_pipeline_args, extract_configs
from langsplat_tpu_torch.config import load_config


def render_set(model_path, name, iteration, cams, field, pipe, sh_degree,
               include_feature, bg, lf_path, feature_level, device):
    from PIL import Image
    from langsplat_tpu_torch.train.loop import render_full

    base = os.path.join(model_path, name, f"ours_{iteration}")
    for sub in ("renders", "gt", "renders_npy", "gt_npy"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)

    for idx, cam in enumerate(cams):
        out = render_full(field, cam, pipe, sh_degree, include_feature, bg,
                          device=device)
        if include_feature:
            rendering = out["language_feature_image"].cpu().numpy()
            gt = cam.get_language_feature(lf_path, feature_level)[0] \
                if lf_path and os.path.isdir(lf_path) else None
        else:
            rendering = out["render"].cpu().numpy()
            gt = cam.image
        np.save(os.path.join(base, "renders_npy", f"{idx:05d}.npy"),
                rendering.transpose(1, 2, 0))
        img8 = (np.clip(rendering, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
        Image.fromarray(img8).save(os.path.join(base, "renders", f"{idx:05d}.png"))
        if gt is not None:
            np.save(os.path.join(base, "gt_npy", f"{idx:05d}.npy"),
                    gt.transpose(1, 2, 0))
            gt8 = (np.clip(gt, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
            Image.fromarray(gt8).save(os.path.join(base, "gt", f"{idx:05d}.png"))


def main(argv=None):
    parser = argparse.ArgumentParser(description="langsplat_tpu_torch rendering")
    add_model_args(parser)
    add_pipeline_args(parser)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--include_feature", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to render on (default: the CUDA card; "
                             "'cpu' runs the plain PyTorch blend)")
    args = parser.parse_args(argv)

    from langsplat_tpu_torch.data.scene import Scene
    from langsplat_tpu_torch.device import resolve_device
    from langsplat_tpu_torch.models import field_io

    device = resolve_device(args.device)
    if args.dp_views_per_device != 1:
        raise NotImplementedError(
            f"--dp_views_per_device {args.dp_views_per_device}: views a rank of a "
            f"multi-device training run; the render CLI renders one view at a time")
    cfg = extract_configs(args)
    # merge the saved run config, as the JAX render CLI does
    saved = os.path.join(cfg.model.model_path, "cfg_args.json")
    if os.path.exists(saved):
        run_cfg = load_config(saved)
        run_cfg.model.model_path = cfg.model.model_path
        if cfg.model.source_path:
            run_cfg.model.source_path = cfg.model.source_path
        cfg = run_cfg

    scene = Scene(cfg.model, device=device, load_iteration=args.iteration,
                  shuffle=False)
    field = scene.gaussians
    iteration = scene.loaded_iter

    ck = os.path.join(cfg.model.model_path, f"chkpnt{iteration}.npz")
    if args.include_feature and os.path.exists(ck):
        field, _, _, _, _ = field_io.load_field(ck, device=device)

    bg = [1.0, 1.0, 1.0] if cfg.model.white_background else [0.0, 0.0, 0.0]
    common = dict(field=field, pipe=cfg.pipeline, sh_degree=cfg.model.sh_degree,
                  include_feature=args.include_feature, bg=bg,
                  lf_path=cfg.model.lf_path, feature_level=cfg.model.feature_level,
                  device=device)
    if not args.skip_train:
        render_set(cfg.model.model_path, "train", iteration,
                   scene.get_train_cameras(), **common)
    if not args.skip_test:
        render_set(cfg.model.model_path, "test", iteration,
                   scene.get_test_cameras(), **common)


if __name__ == "__main__":
    main(sys.argv[1:])
