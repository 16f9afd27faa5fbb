"""Evaluation visualization files, PyTorch port's copy of
`langsplat_tpu/evaluation/viz.py` (numpy and PIL, on the host):

  <out>/<frame>/heatmap/<prompt>_<level>.png     relevancy heatmaps (turbo)
  <out>/<frame>/composited/<prompt>_<level>.png  activation composited over the image
  <out>/<frame>/chosen_<prompt>.png              chosen-level binary mask
  <out>/<frame>/localization/<prompt>.png        argmax point + GT boxes figure

Only `localization_png` needs matplotlib (a pyplot figure); it imports it when called.
"""

from __future__ import annotations

import os

import numpy as np

from langsplat_tpu_torch.evaluation.colormaps import ColormapOptions, apply_colormap

HEATMAP_OPTIONS = ColormapOptions(colormap="turbo", normalize=True,
                                  colormap_min=-1.0, colormap_max=1.0)


def save_image(image01: np.ndarray, path: str) -> None:
    """float [H,W,3] in [0,1] -> png."""
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = (np.clip(np.asarray(image01), 0, 1) * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def save_mask(mask01: np.ndarray, path: str) -> None:
    """binary [H,W] -> 0/255 png."""
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((np.asarray(mask01) != 0).astype(np.uint8) * 255).save(path)


def heatmap_png(relevancy: np.ndarray, path: str) -> None:
    """Smoothed relevancy [H,W] -> turbo heatmap png (normalized, -1..1 options)."""
    save_image(apply_colormap(relevancy[..., None].astype(np.float32),
                              HEATMAP_OPTIONS), path)


def composited_png(relevancy: np.ndarray, rgb_img: np.ndarray, path: str,
                   bg_thresh: float = 0.5) -> None:
    """Activation colormap over the dimmed source image: activation < bg_thresh shows
    0.3x the image."""
    p_i = np.clip(relevancy - bg_thresh, 0, 1)[..., None].astype(np.float32)
    composited = apply_colormap(p_i / (p_i.max() + 1e-6),
                                ColormapOptions(colormap="turbo"))
    mask = relevancy < bg_thresh
    composited[mask, :] = np.asarray(rgb_img)[mask, :] * 0.3
    save_image(composited, path)


def localization_png(image01: np.ndarray, point_xy: np.ndarray,
                     bboxes: np.ndarray, path: str) -> None:
    """Composited image + argmax point + dotted GT boxes."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig = plt.figure()
    ax = plt.gca()
    ax.imshow(np.clip(image01, 0, 1))
    ax.add_patch(plt.Rectangle((0, 0), image01.shape[1] - 1, image01.shape[0] - 1,
                               linewidth=0, edgecolor="none", facecolor="white",
                               alpha=0.3))
    pt = np.asarray(point_xy).reshape(1, -1)
    ax.scatter(pt[:, 0], pt[:, 1], color="firebrick", marker="o", s=100,
               edgecolor="black", linewidth=2.5, alpha=1)
    for box in np.asarray(bboxes).reshape(-1, 4):
        x0, y0 = box[0], box[1]
        bw, bh = box[2] - box[0], box[3] - box[1]
        ax.add_patch(plt.Rectangle((x0, y0), bw, bh, edgecolor="black",
                                   facecolor=(0, 0, 0, 0), lw=4,
                                   capstyle="round", joinstyle="round",
                                   linestyle="dotted"))
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight", pad_inches=0.0, dpi=200)
    plt.close(fig)
