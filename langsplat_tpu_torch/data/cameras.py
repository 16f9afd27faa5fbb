"""Host-side camera objects: matrices, ground-truth images, language-feature loading.

PyTorch-port counterpart of `langsplat_tpu/data/cameras.py`, in numpy: the matrices are
static per view and are moved to the device by the renderer.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field

import numpy as np

from langsplat_tpu_torch.core import transforms


@dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray               # cam-to-world rotation (COLMAP convention)
    T: np.ndarray               # world-to-cam translation
    fov_x: float
    fov_y: float
    image: np.ndarray | None    # [3, H, W] float32 in [0,1], alpha pre-multiplied
    image_name: str
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0

    def __post_init__(self):
        # row-vector convention matrices
        self.world_view_transform = transforms.world_to_view(
            self.R, self.T, self.trans, self.scale).T.astype(np.float32)
        proj = transforms.projection_matrix(self.znear, self.zfar,
                                            self.fov_x, self.fov_y).T
        self.full_proj_transform = (self.world_view_transform @ proj).astype(np.float32)
        self.camera_center = np.linalg.inv(
            self.world_view_transform)[3, :3].astype(np.float32)

    @property
    def tanfovx(self) -> float:
        return float(np.tan(self.fov_x * 0.5))

    @property
    def tanfovy(self) -> float:
        return float(np.tan(self.fov_y * 0.5))

    def get_language_feature(self, language_feature_dir: str,
                             feature_level: int) -> tuple[np.ndarray, np.ndarray]:
        """(feature [F, H, W], mask [1, H, W]) from the `<image>_s.npy` seg map and
        the `<image>_f.npy` feature table (the numpy path of the JAX package; its
        native C++ loader is not ported yet).

        feature_level: 0=default, 1=s, 2=m, 3=l SAM granularity.
        """
        base = os.path.join(language_feature_dir, self.image_name)
        if not 0 <= feature_level <= 3:
            raise ValueError(f"feature_level={feature_level}")

        seg_map = np.load(base + "_s.npy")          # [4, H', W'] int
        feature_map = np.load(base + "_f.npy")      # [M, F]
        seg = seg_map[feature_level]
        if seg.shape != (self.height, self.width):
            # the reference assumes seg maps match the camera resolution and crashes
            # otherwise; resize with nearest neighbor instead (ids are categorical)
            warnings.warn(f"seg map {seg.shape} != image {(self.height, self.width)}; "
                          "nearest-resizing")
            ys = (np.arange(self.height) * seg.shape[0] // self.height)
            xs = (np.arange(self.width) * seg.shape[1] // self.width)
            seg = seg[np.ix_(ys, xs)]
        seg = seg.astype(np.int64)
        mask = (seg != -1)[None].astype(np.float32)
        feature = feature_map[np.clip(seg, 0, len(feature_map) - 1)]  # [H, W, F]
        feature = np.where(mask[0][..., None] > 0, feature, 0.0)
        return feature.transpose(2, 0, 1).astype(np.float32), mask


def load_camera(info, resolution_scale: float, resolution: int,
                uid: int) -> Camera:
    """Apply the reference resolution policy and build a Camera.

    `info` is a CameraInfo from dataset readers; `resolution` -1 auto-downscales
    >1600px-wide images (utils/camera_utils.py:25-37).
    """
    orig_w, orig_h = info.width, info.height
    if resolution in (1, 2, 4, 8):
        scale = resolution_scale * resolution
    else:
        if resolution == -1:
            global_down = max(orig_w / 1600, 1.0)
        else:
            global_down = orig_w / resolution
        scale = global_down * resolution_scale
    w, h = round(orig_w / scale), round(orig_h / scale)

    image = info.load_image(w, h) if info.image_path else None
    return Camera(uid=uid, colmap_id=info.uid, R=info.R, T=info.T,
                  fov_x=info.fov_x, fov_y=info.fov_y, image=image,
                  image_name=info.image_name, width=w, height=h)


def camera_to_json(idx: int, cam) -> dict:
    """The cameras.json entry of a CameraInfo (or Camera), as the JAX package writes it."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = cam.R.transpose()
    rt[:3, 3] = cam.T
    rt[3, 3] = 1.0
    c2w = np.linalg.inv(rt)
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": transforms.fov_to_focal(cam.fov_y, cam.height),
        "fx": transforms.fov_to_focal(cam.fov_x, cam.width),
    }
