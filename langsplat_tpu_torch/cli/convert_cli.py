"""COLMAP preprocessing CLI of the PyTorch port: the same flags, commands and layout as
`langsplat_tpu/cli/convert_cli.py`.

    python -m langsplat_tpu_torch.cli.convert_cli -s <scene> [--resize] [--no_gpu]

Runs the colmap binaries (feature_extractor -> exhaustive_matcher -> mapper ->
image_undistorter) on `<scene>/input`, moves the undistorted model into `sparse/0`, and
with --resize writes 2x, 4x and 8x downscaled copies of `images/` (PIL). A failed
command ends the run with its exit code. It needs a local colmap install and does no
device work.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd: str) -> None:
    code = subprocess.call(cmd, shell=True)
    if code != 0:
        print(f"command failed with code {code}: {cmd}")
        sys.exit(code)


def main(argv=None):
    parser = argparse.ArgumentParser("Colmap converter")
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="SIMPLE_PINHOLE", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--resize", action="store_true")
    args = parser.parse_args(argv)

    colmap = f'"{args.colmap_executable}"' if args.colmap_executable else "colmap"
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(src + "/distorted/sparse", exist_ok=True)
        run(f"{colmap} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}")
        run(f"{colmap} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}")
        run(f"{colmap} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001")

    run(f"{colmap} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        f" --output_type COLMAP")

    # move the undistorter's sparse/* into sparse/0, where the scene readers look
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:
        from PIL import Image
        for factor in (2, 4, 8):
            out_dir = os.path.join(src, f"images_{factor}")
            os.makedirs(out_dir, exist_ok=True)
            for name in os.listdir(os.path.join(src, "images")):
                with Image.open(os.path.join(src, "images", name)) as im:
                    im.resize((im.width // factor, im.height // factor)).save(
                        os.path.join(out_dir, name))

    print("Done.")


if __name__ == "__main__":
    main(sys.argv[1:])
