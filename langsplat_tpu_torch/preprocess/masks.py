"""Mask post-processing of the language-feature preprocessing, PyTorch counterpart of
`langsplat_tpu/preprocess/masks.py`.

  - `mask_nms`: score-sorted NMS with an extra inner-overlap suppression and top-3
    fallbacks; the pairwise intersections are one [M, HW] x [HW, M] float32 product on
    the masks' device (integer counts below 2^24, so exact; TF32 is kept off);
  - `masks_update`: score = stability * predicted IoU, NMS per granularity level;
  - `mask_to_segmap`: crop -> pad to a square -> 224^2 CLIP tiles, and the -1-filled
    segment-id map, built on the masks' device.

Tracing (`utils/tracing.py`): `masks_update` is the span `masks_update`, one `mask_nms`
a level inside it, with the counters `mask_nms.masks` (masks in) and `mask_nms.kept`;
every host-device sync goes through a counted `sync.mask_nms.*` or `sync.clip_tiles.*`
span.

No OpenCV: `resize_linear` is `cv2.resize(..., INTER_LINEAR)` on uint8 images written
out as tensor operations, bit for bit. OpenCV takes 11-bit fixed-point weights from
(d + 1/2) * scale - 1/2 (the x taps clamped to the border, the y rows clipped), sums the
two horizontal taps in integers and combines the two rows as its SIMD path does:
((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16), rounded by (+2) >> 2. It neither
antialiases when it shrinks (PIL does) nor interpolates as `F.interpolate` does.
"""

from __future__ import annotations

import numpy as np
import torch

from langsplat_tpu_torch.utils import tracing

COEF_SCALE = 2048        # OpenCV's INTER_RESIZE_COEF_SCALE (11 fractional bits)
TILE = 224               # CLIP's input size


def mask_nms_matrices(masks_flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[M, HW] float32 (score-sorted) -> (iou [M, M], inner [M, M]) as the JAX
    package's `_mask_nms_matrices`: inner holds 1 - frac_j * frac_i at [i, j] (j > i)
    where the column mask is nested in the row mask, and at [j, i] for the reverse."""
    area = masks_flat.sum(dim=1)
    inter = masks_flat @ masks_flat.T
    union = area[:, None] + area[None, :] - inter
    iou = inter / torch.clamp(union, min=1e-12)
    frac_i = inter / torch.clamp(area[:, None], min=1e-12)
    frac_j = inter / torch.clamp(area[None, :], min=1e-12)
    inner_val = 1.0 - frac_j * frac_i
    cond_upper = (frac_i < 0.5) & (frac_j >= 0.85)
    cond_lower = (frac_i >= 0.85) & (frac_j < 0.5)
    upper = torch.where(torch.triu(cond_upper, diagonal=1), inner_val, 0.0)
    lower = torch.where(torch.tril(cond_lower.T, diagonal=-1), inner_val, 0.0)
    return iou, upper + lower


def mask_nms(masks: torch.Tensor, scores, iou_thr: float = 0.7, score_thr: float = 0.1,
             inner_thr: float = 0.2) -> np.ndarray:
    """Indices (into the original order) of the masks kept. `masks` [M, H, W] bool on
    any device; `scores` [M], compared in float64 as the JAX package does."""
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="stable")
    m = len(order)
    # the order and the sorted scores in one upload (float64 holds every index exactly)
    ordered = tracing.upload("mask_nms.order", np.stack([order, scores[order]]),
                             device=masks.device)
    scores_ord = ordered[1]
    flat = masks[ordered[0].long()].reshape(m, -1).float()
    iou, inner = mask_nms_matrices(flat)
    del flat

    iou_max = torch.triu(iou, diagonal=1).amax(dim=0)
    inner_max_u = torch.triu(inner, diagonal=1).amax(dim=0)
    inner_max_l = torch.tril(inner, diagonal=1).amax(dim=0)

    keep = iou_max <= iou_thr
    keep_conf = scores_ord > score_thr
    keep_inner_u = inner_max_u <= 1 - inner_thr
    keep_inner_l = inner_max_l <= 1 - inner_thr
    # the scores are sorted (stable), so the top 3 are the first 3
    for name, k in (("conf", keep_conf), ("inner_u", keep_inner_u),
                    ("inner_l", keep_inner_l)):
        if not tracing.host_read(f"mask_nms.{name}", k.any()):
            k[:3] = True
    keep = keep & keep_conf & keep_inner_u & keep_inner_l
    with tracing.synced("mask_nms.keep"):
        return order[keep.cpu().numpy()]


@tracing.traced("masks_update")
def masks_update(*mask_lists, iou_thr: float = 0.8, score_thr: float = 0.7,
                 inner_thr: float = 0.5):
    """NMS per granularity level on stability * predicted-IoU scores."""
    out = []
    for masks_lvl in mask_lists:
        if not masks_lvl:
            out.append(masks_lvl)
            continue
        seg = torch.stack([m["segmentation"] for m in masks_lvl])
        iou_pred = np.array([m["predicted_iou"] for m in masks_lvl])
        stability = np.array([m["stability_score"] for m in masks_lvl])
        with tracing.span("mask_nms"):
            keep = set(mask_nms(seg, stability * iou_pred, iou_thr=iou_thr,
                                score_thr=score_thr, inner_thr=inner_thr).tolist())
        tracing.COUNTERS["mask_nms.masks"] += len(masks_lvl)
        tracing.COUNTERS["mask_nms.kept"] += len(keep)
        out.append([m for i, m in enumerate(masks_lvl) if i in keep])
    return tuple(out)


# ---------------------------------------------------------------------------
# cv2.resize(INTER_LINEAR) on uint8, and the CLIP tiles
# ---------------------------------------------------------------------------

def _taps(src: torch.Tensor, dst: int, clamp: bool):
    """OpenCV's linear taps from sources of `src` [B] pixels to `dst` pixels: (first
    index, second index, first weight, second weight), each [B, dst]. `clamp`
    (the x axis) resets the fraction to 0 at both borders; the y rows are clipped."""
    scale = 1.0 / (dst / src.double())                       # [B] float64
    d = torch.arange(dst, dtype=torch.float64, device=src.device)
    f = ((d[None, :] + 0.5) * scale[:, None] - 0.5).float()
    s = torch.floor(f)
    f = f - s
    s = s.long()
    last = (src - 1)[:, None]
    if clamp:
        edge = (s < 0) | (s >= last)
        f = torch.where(edge, 0.0, f)
        s = torch.minimum(torch.clamp(s, min=0), last)
        s1 = torch.minimum(s + 1, last)
    else:
        s1 = torch.clamp(torch.minimum(s + 1, last), min=0)
        s = torch.minimum(torch.clamp(s, min=0), last)
    w0 = torch.round((1.0 - f) * COEF_SCALE).int()
    w1 = torch.round(f * COEF_SCALE).int()
    return s, s1, w0, w1


def _vertical(r0: torch.Tensor, r1: torch.Tensor, b0: torch.Tensor,
              b1: torch.Tensor) -> torch.Tensor:
    """OpenCV's vertical pass of two horizontally resized rows (int32) to uint8."""
    out = ((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16)
    return torch.clamp((out + 2) >> 2, 0, 255).to(torch.uint8)


def resize_linear(image: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """`cv2.resize(image, (width, height))` (INTER_LINEAR) of an [h, w, C] uint8
    tensor, bit for bit, on its device."""
    h, w = image.shape[:2]
    dev = image.device
    x0, x1, a0, a1 = (t[0] for t in _taps(torch.tensor([w], device=dev), width, True))
    y0, y1, b0, b1 = (t[0] for t in _taps(torch.tensor([h], device=dev), height, False))
    src = image.int()

    def hrow(rows):
        return (src[rows][:, x0] * a0[None, :, None]
                + src[rows][:, x1] * a1[None, :, None])
    return _vertical(hrow(y0), hrow(y1), b0[:, None, None], b1[:, None, None])


def get_seg_img(mask: dict, image: torch.Tensor) -> torch.Tensor:
    """Zero-background crop of the mask's bbox ([h, w, 3] uint8, on the image's
    device)."""
    img = image * mask["segmentation"][..., None].to(image.dtype)
    x, y, w, h = np.int32(mask["bbox"])
    return img[y:y + h, x:x + w]


def pad_img(img: torch.Tensor) -> torch.Tensor:
    """Pad to a square with zeros, centered."""
    h, w, _ = img.shape
    side = max(w, h)
    pad = torch.zeros((side, side, 3), dtype=torch.uint8, device=img.device)
    if h > w:
        pad[:, (h - w) // 2:(h - w) // 2 + w] = img
    else:
        pad[(w - h) // 2:(w - h) // 2 + h, :] = img
    return pad


def _tiles(image: torch.Tensor, segs: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[M, 224, 224, 3] uint8: `resize_linear(pad_img(get_seg_img(...)), 224, 224)` of
    every mask at once, gathered straight from the image (no crop is materialized).
    `boxes` [M, 4] int64 XYWH on the image's device."""
    dev = image.device
    height, width = image.shape[:2]
    x, y, w, h = boxes.T
    side = torch.maximum(w, h)
    off_x = torch.where(h > w, (h - w) // 2, 0)
    off_y = torch.where(h > w, 0, (w - h) // 2)
    c0, c1, a0, a1 = _taps(side, TILE, True)
    r0, r1, b0, b1 = _taps(side, TILE, False)
    flat_img = image.reshape(-1, 3).int()
    flat_seg = segs.reshape(len(segs), -1)
    batch = torch.arange(len(segs), device=dev)[:, None, None]

    def value(rows, cols):
        """Padded-crop pixels [M, 224, 224, 3] at padded (rows [M, 224], cols [M, 224])."""
        ry = rows - off_y[:, None]
        cx = cols - off_x[:, None]
        ok = (((ry >= 0) & (ry < h[:, None]))[:, :, None]
              & ((cx >= 0) & (cx < w[:, None]))[:, None, :])
        iy = torch.clamp(y[:, None] + ry, 0, height - 1)
        ix = torch.clamp(x[:, None] + cx, 0, width - 1)
        idx = iy[:, :, None] * width + ix[:, None, :]
        keep = ok & flat_seg[batch, idx]
        return flat_img[idx] * keep[..., None]

    def hrow(rows):
        return (value(rows, c0) * a0[:, None, :, None]
                + value(rows, c1) * a1[:, None, :, None])
    return _vertical(hrow(r0), hrow(r1), b0[:, :, None, None], b1[:, :, None, None])


def mask_to_segmap(masks: list[dict], image: torch.Tensor, chunk: int = 64
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (CLIP tiles [M, 3, 224, 224] float32 in [0, 1], seg map [H, W] int32 with -1
    for the background, a later mask overwriting an earlier one), on the image's
    device. `image` is [H, W, 3] uint8."""
    segs = torch.stack([m["segmentation"] for m in masks]).to(image.device)
    boxes = np.int32(np.stack([m["bbox"] for m in masks]))
    boxes = tracing.upload("clip_tiles.boxes", boxes, dtype=torch.int64, device=image.device)
    tiles = torch.cat([_tiles(image, segs[i:i + chunk], boxes[i:i + chunk])
                       for i in range(0, len(masks), chunk)])
    # uint8 -> [0, 1] by a table of x / 255 rounded once, on the host as numpy does: the
    # card's division by a scalar multiplies by its reciprocal and can round otherwise
    unit = tracing.upload("clip_tiles.unit", np.arange(256, dtype=np.float32)
                          / np.float32(255), device=image.device)
    tiles = unit[tiles.long()].permute(0, 3, 1, 2).contiguous()
    ids = torch.arange(1, len(masks) + 1, dtype=torch.int32, device=image.device)
    seg_map = torch.zeros(image.shape[:2], dtype=torch.int32, device=image.device)
    for i in range(0, len(masks), chunk):
        top = (segs[i:i + chunk] * ids[i:i + chunk, None, None]).amax(dim=0)
        seg_map = torch.maximum(seg_map, top)
    return tiles, seg_map - 1
