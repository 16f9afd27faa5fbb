"""Language-feature extraction (`process.sh` step 1), PyTorch counterpart of
`langsplat_tpu/preprocess/pipeline.py`: per image, SAM masks at four granularities
(`generate`), then `embed_masks`: `masks_update` (IoU 0.8, score 0.7, inner 0.5), a
224^2 CLIP tile per mask, CLIP embeddings L2-normalized and stored as float16, and the
files the training and the autoencoder read: `<image>_f.npy` [M, 512] and
`<image>_s.npy` [4, H, W] int32 seg maps whose ids carry cumulative offsets per level
(-1 for no mask).

The mask generator and the image encoder are injected (see backends.py); the masks,
tiles, seg maps and embeddings stay on the masks' device until the files are written.
Tracing (`utils/tracing.py`): the root span `embed_masks` a call, holding
`masks_update` (`mask_nms` a level), `clip_tiles` a level and the encoder's own spans
(`clip_encoder` a batch for `backends.ClipImageEncoder`).
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch

from langsplat_tpu_torch.device import resolve_device
from langsplat_tpu_torch.preprocess.masks import mask_to_segmap, masks_update, resize_linear
from langsplat_tpu_torch.utils import tracing

LEVELS = ("default", "s", "m", "l")


def embed_image(image: np.ndarray, mask_generator, clip_encode: Callable,
                levels=LEVELS) -> tuple[dict, dict]:
    """One [H, W, 3] uint8 image -> `embed_masks` of the generator's masks."""
    return embed_masks(image, mask_generator.generate(image), clip_encode, levels)


@tracing.traced("embed_masks")
def embed_masks(image: np.ndarray, masks_4, clip_encode: Callable,
                levels=LEVELS) -> tuple[dict, dict]:
    """One [H, W, 3] uint8 image and its mask records at four levels, as
    `AutoMaskGenerator.generate` gives them -> ({level: [Mi, D] float16 embeddings},
    {level: [H, W] int32 seg map}), tensors on the masks' device. Levels without masks
    are left out; the default level must have some."""
    if not masks_4[0]:
        raise ValueError("no masks at the default level")
    device = masks_4[0][0]["segmentation"].device
    masks_4 = masks_update(*masks_4, iou_thr=0.8, score_thr=0.7, inner_thr=0.5)
    img = tracing.upload("embed_masks.image", np.ascontiguousarray(image), device=device)
    embeds, seg_maps = {}, {}
    for level, masks_lvl in zip(levels, masks_4):
        if len(masks_lvl) == 0:
            if level == "default":
                raise ValueError("no masks at the default level")
            continue
        with tracing.span("clip_tiles"):
            tiles, seg_map = mask_to_segmap(masks_lvl, img)
        emb = torch.as_tensor(clip_encode(tiles), device=img.device)
        emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-12)
        embeds[level] = emb.half()
        seg_maps[level] = seg_map
    return embeds, seg_maps


def create(image_list: list[np.ndarray], name_list: list[str], save_folder: str,
           mask_generator, clip_encode: Callable) -> None:
    """Write `<save_folder>/<name>_{s,f}.npy` for every image."""
    os.makedirs(save_folder, exist_ok=True)
    for image, name in zip(image_list, name_list):
        embeds, seg_maps = embed_image(image, mask_generator, clip_encode)
        levels = list(embeds.keys())
        lengths = [len(embeds[k]) for k in levels]
        features = torch.cat([embeds[k] for k in levels])

        # level j's ids shift by the counts of the levels before it
        offsets = np.cumsum([0] + lengths[:-1])
        stacked = []
        for j, k in enumerate(levels):
            v = seg_maps[k]
            if int(v.max()) != lengths[j] - 1:
                raise RuntimeError(f"{name}: level {k} seg map tops at {int(v.max())}, "
                                   f"not {lengths[j] - 1}")
            stacked.append(torch.where(v != -1, v + int(offsets[j]), v))
        # the file keeps 4 rows; missing levels replicate the default level
        while len(stacked) < 4:
            stacked.append(stacked[0])
        write_features(os.path.join(save_folder, os.path.splitext(name)[0]),
                       torch.stack(stacked[:4]), features)


def write_features(base: str, seg_map: torch.Tensor, features: torch.Tensor) -> None:
    """`<base>_s.npy` (int32 [4, H, W]) and `<base>_f.npy` (float16 [M, D])."""
    np.save(base + "_s.npy", seg_map.cpu().numpy())
    np.save(base + "_f.npy", features.cpu().numpy())


def load_scene_images(dataset_path: str, resolution: int = -1,
                      images_dir: str = "images", device=None):
    """The scene's images, decoded by PIL as RGB, downscaled to 1080 rows when taller
    (or to `resolution` columns) by `masks.resize_linear` (OpenCV's INTER_LINEAR) on the
    CUDA card unless `device` says otherwise. Returns ([H, W, 3] uint8 arrays, file
    names), sorted by name."""
    from PIL import Image
    device = resolve_device(device)
    img_folder = os.path.join(dataset_path, images_dir)
    data_list = sorted(os.listdir(img_folder))
    images = []
    for name in data_list:
        with Image.open(os.path.join(img_folder, name)) as im:
            rgb = np.array(im.convert("RGB"))
        orig_h, orig_w = rgb.shape[:2]
        if resolution == -1:
            global_down = orig_h / 1080 if orig_h > 1080 else 1.0
        else:
            global_down = orig_w / resolution
        size = (int(orig_w / global_down), int(orig_h / global_down))
        images.append(resize_linear(torch.as_tensor(rgb, device=device), *size)
                      .cpu().numpy())
    return images, data_list
