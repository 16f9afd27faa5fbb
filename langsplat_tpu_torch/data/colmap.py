"""COLMAP sparse-reconstruction parsers (binary and text).

A copy of `langsplat_tpu/data/colmap.py` (numpy only), kept in the port so that it
imports nothing of the JAX package. Formats are COLMAP's documented serializations:
cameras.bin / images.bin / points3D.bin and their .txt variants.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np

# camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: i for i, (name, _) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray   # (w,x,y,z)
    tvec: np.ndarray
    camera_id: int
    name: str


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """(w,x,y,z) -> 3x3 (reference qvec2rotmat, colmap_loader.py:43)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(f, fmt: str):
    size = struct.calcsize("<" + fmt)
    return struct.unpack("<" + fmt, f.read(size))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read(f, "iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * num_params))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cams[cam_id] = ColmapCamera(cam_id, parts[1], int(parts[2]), int(parts[3]),
                                        np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            vals = _read(f, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "Q")
            f.seek(24 * num_pts, os.SEEK_CUR)  # skip (x d, y d, id q) tracks
            images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id,
                                           name.decode("utf-8"))
    return images


def read_images_text(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.strip().startswith("#")]
    for i in range(0, len(lines), 2):  # every other line is the 2D point list
        parts = lines[i].split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        images[image_id] = ColmapImage(image_id, qvec, tvec, int(parts[8]), parts[9])
    return images


def read_points3d_binary(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (xyz [N,3] f64, rgb [N,3] u8, error [N])."""
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (num,) = _read(f, "Q")
        for _ in range(num):
            vals = _read(f, "QdddBBBd")
            xyzs.append(vals[1:4])
            rgbs.append(vals[4:7])
            errs.append(vals[7])
            (track_len,) = _read(f, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return (np.array(xyzs, np.float64).reshape(-1, 3),
            np.array(rgbs, np.uint8).reshape(-1, 3),
            np.array(errs, np.float64))


def read_points3d_text(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(p) for p in parts[1:4]])
            rgbs.append([int(p) for p in parts[4:7]])
            errs.append(float(parts[7]))
    return (np.array(xyzs, np.float64).reshape(-1, 3),
            np.array(rgbs, np.uint8).reshape(-1, 3),
            np.array(errs, np.float64))


def focal_and_fov(cam: ColmapCamera) -> tuple[float, float]:
    """-> (fov_x, fov_y) radians. Supports SIMPLE_PINHOLE/PINHOLE like the reference
    (`scene/dataset_readers.py:68-109`)."""
    from langsplat_tpu_torch.core.transforms import focal_to_fov
    if cam.model == "SIMPLE_PINHOLE":
        f = cam.params[0]
        return focal_to_fov(f, cam.width), focal_to_fov(f, cam.height)
    if cam.model == "PINHOLE":
        fx, fy = cam.params[0], cam.params[1]
        return focal_to_fov(fx, cam.width), focal_to_fov(fy, cam.height)
    raise ValueError(f"unsupported COLMAP camera model {cam.model}; undistort first "
                     "(e.g. colmap image_undistorter)")
