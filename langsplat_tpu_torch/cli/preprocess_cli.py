"""Preprocessing CLI of the PyTorch port (`process.sh` step 1), with the flags of
`langsplat_tpu/cli/preprocess_cli.py`:

    python -m langsplat_tpu_torch.cli.preprocess_cli --dataset_path <scene> \
        --sam_model <local SAM checkpoint dir> --clip_model <local CLIP checkpoint dir> \
        [--resolution -1] [--points_per_side 32] [--device cpu]

Reads `<scene>/images/*`, generates SAM masks at four granularities (32x32 points, one
crop layer, IoU 0.7, stability 0.85, box NMS 0.7, regions under 100 px removed) with
the port's SAM (`models/sam.py`, loaded from the `transformers`-layout directory
--sam_model; each crop encoded once), embeds each mask's 224^2 tile with the port's CLIP
image tower (`models/clip.py`, loaded from the `transformers`-layout directory
--clip_model) and writes `<scene>/language_features/<image>_{f,s}.npy`.
It runs on the CUDA card unless --device says otherwise, and fails without a card (the
JAX CLI defaults to the CPU).
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def auto_mask_config(points_per_side: int = 32):
    """The generator's configuration in this CLI."""
    from langsplat_tpu_torch.preprocess.auto_mask import AutoMaskConfig
    return AutoMaskConfig(points_per_side=points_per_side, pred_iou_thresh=0.7,
                          box_nms_thresh=0.7, stability_score_thresh=0.85,
                          crop_n_layers=1, min_mask_region_area=100)


def main(argv=None, predictor=None, clip_encode=None):
    """`predictor` and `clip_encode`, when given, stand in for the SAM and the CLIP image
    tower (the port's own, `models/sam.py` and `models/clip.py`) that --sam_model and
    --clip_model would load."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--resolution", type=int, default=-1)
    parser.add_argument("--sam_model", type=str, default="facebook/sam-vit-huge")
    parser.add_argument("--clip_model", type=str,
                        default="laion/CLIP-ViT-B-16-laion2B-s34b-b88k")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; 'cpu' to run on the "
                             "CPU)")
    parser.add_argument("--points_per_side", type=int, default=32)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)
    seed_everything(args.seed)

    from langsplat_tpu_torch.device import float32_matmul_highest, resolve_device
    from langsplat_tpu_torch.preprocess.auto_mask import AutoMaskGenerator
    from langsplat_tpu_torch.preprocess.backends import ClipImageEncoder, SamPredictor
    from langsplat_tpu_torch.preprocess.pipeline import create, load_scene_images

    device = resolve_device(args.device)
    float32_matmul_highest()
    if predictor is None:
        predictor = SamPredictor(args.sam_model, device=device)
    if clip_encode is None:
        clip_encode = ClipImageEncoder(args.clip_model, device=device)
    generator = AutoMaskGenerator(predictor, auto_mask_config(args.points_per_side),
                                  device=device)

    images, names = load_scene_images(args.dataset_path, args.resolution, device=device)
    save_folder = os.path.join(args.dataset_path, "language_features")
    create(images, names, save_folder, generator, clip_encode)
    print(f"wrote language features for {len(images)} images to {save_folder}")


if __name__ == "__main__":
    main(sys.argv[1:])
