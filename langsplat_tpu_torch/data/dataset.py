"""Scene dataset readers: COLMAP sparse reconstructions and Blender synthetic scenes.

A copy of `langsplat_tpu/data/dataset.py` (numpy and PIL only), kept in the port so that
it imports nothing of the JAX package: the same directory-shape dispatch, every-8th-image
eval split (llffhold), NeRF++ camera-bounding radius, points3D->ply conversion, and
white-background alpha composite for Blender scenes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable

import numpy as np

from langsplat_tpu_torch.core.transforms import focal_to_fov
from langsplat_tpu_torch.data import colmap, ply


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray
    T: np.ndarray
    fov_x: float
    fov_y: float
    image_path: str
    image_name: str
    width: int
    height: int
    bg_white: bool = False

    def load_image(self, w: int, h: int) -> np.ndarray:
        """[3, H, W] float32 in [0,1]; alpha composited (Blender) / masked."""
        from PIL import Image
        img = Image.open(self.image_path)
        if (img.width, img.height) != (w, h):
            img = img.resize((w, h))
        arr = np.asarray(img).astype(np.float32) / 255.0
        if arr.ndim == 2:
            arr = arr[..., None].repeat(3, axis=-1)
        if arr.shape[-1] == 4:
            rgb, alpha = arr[..., :3], arr[..., 3:4]
            bg = 1.0 if self.bg_white else 0.0
            arr = rgb * alpha + bg * (1 - alpha)
        return np.clip(arr.transpose(2, 0, 1), 0.0, 1.0)


@dataclass
class SceneInfo:
    point_cloud: tuple            # (points [N,3], colors [N,3], normals [N,3])
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos) -> dict:
    """Camera-bounding translate/radius (reference getNerfppNorm,
    dataset_readers.py:45-66)."""
    centers = []
    for cam in cam_infos:
        w2c = np.eye(4)
        w2c[:3, :3] = cam.R.T
        w2c[:3, 3] = cam.T
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    dists = np.linalg.norm(centers - avg, axis=1)
    diagonal = float(dists.max())
    radius = diagonal * 1.1
    return {"translate": -avg, "radius": radius}


def read_colmap_scene(path: str, images_dir: str = "images", eval_split: bool = False,
                      llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        cams = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        imgs = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))
        imgs = colmap.read_images_text(os.path.join(sparse, "images.txt"))

    cam_infos = []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        cam = cams[img.camera_id]
        fov_x, fov_y = colmap.focal_and_fov(cam)
        image_path = os.path.join(path, images_dir, img.name)
        cam_infos.append(CameraInfo(
            uid=img.id, R=colmap.qvec_to_rotmat(img.qvec).T, T=img.tvec,
            fov_x=fov_x, fov_y=fov_y, image_path=image_path,
            image_name=os.path.splitext(img.name)[0],
            width=cam.width, height=cam.height))

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        ply.write_point_cloud(ply_path, xyz, rgb.astype(np.float32) / 255.0)
    pts, cols, nrm = ply.read_point_cloud(ply_path)
    return SceneInfo(point_cloud=(pts, cols, nrm), train_cameras=train,
                     test_cameras=test, nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


def read_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True, extension: str = ".png") -> SceneInfo:
    def read_split(transforms_file):
        with open(os.path.join(path, transforms_file)) as f:
            meta = json.load(f)
        fov_x = meta["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(meta["frames"]):
            file_path = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # blender (Y up, Z back) -> COLMAP (Y down, Z fwd)
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            from PIL import Image
            with Image.open(file_path) as im:
                width, height = im.size
            fov_y = focal_to_fov(
                width / (2 * np.tan(fov_x / 2)), height)
            infos.append(CameraInfo(
                uid=idx, R=R, T=T, fov_x=fov_x, fov_y=fov_y,
                image_path=file_path,
                image_name=os.path.basename(frame["file_path"]),
                width=width, height=height, bg_white=white_background))
        return infos

    train = read_split("transforms_train.json")
    test = read_split("transforms_test.json") if (
        eval_split and os.path.exists(os.path.join(path, "transforms_test.json"))
    ) else []

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        n = 100_000
        rng = np.random.default_rng(0)
        pts = (rng.random((n, 3)) * 2.6 - 1.3).astype(np.float32)
        cols = rng.random((n, 3)).astype(np.float32)
        ply.write_point_cloud(ply_path, pts, cols)
    pts, cols, nrm = ply.read_point_cloud(ply_path)
    return SceneInfo(point_cloud=(pts, cols, nrm), train_cameras=train,
                     test_cameras=test, nerf_normalization=get_nerfpp_norm(train),
                     ply_path=ply_path)


SCENE_LOADERS: dict[str, Callable] = {
    "colmap": read_colmap_scene,
    "blender": read_blender_scene,
}


def detect_scene_type(path: str) -> str:
    if os.path.exists(os.path.join(path, "sparse")):
        return "colmap"
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return "blender"
    raise ValueError(f"cannot infer scene type at {path}")
