"""Automatic mask generation at four granularities (default / s / m / l), PyTorch
counterpart of `langsplat_tpu/preprocess/auto_mask.py` (the segment-anything-langsplat
fork's generator: the best-IoU head plus the three granularity heads).

The predictor is injected: `predictor(crop [h, w, 3] uint8, points [P, 2] xy pixels) ->
(masks [P, 3, h, w] bool, iou_preds [P, 3], logits [P, 3, h, w])`, as tensors on the
generator's device (numpy arrays are uploaded). A predictor that also has
`set_image(crop)`, `decode(points) -> (low-res logits, iou_preds)` and
`upscale(low-res logits) -> logits` (`backends.SamPredictor`) encodes each crop once,
as upstream SAM's generator does, and decodes its batches against that embedding.

Per batch of points, the stability score, the IoU and stability filters and the
empty-mask test run as tensor operations over the whole batch on that device; the
surviving masks go to the host once for `remove_small_regions` (scipy's labelling, no
OpenCV), the bounding boxes and the near-crop-edge test, and the kept ones come back
once. Records come out in the JAX package's order (points, then heads; the best head
also goes to `default`, after its own head), per-head box NMS per crop, then a
cross-crop NMS that prefers smaller crops, with every kept list re-sorted by index.
Each record's `segmentation` is an [H, W] bool tensor on the device.

Tracing (`utils/tracing.py`): the root span `generate` a call, holding `sam_encoder`
a crop, `sam_decoder` a batch (the prompt encoder and mask decoder), `sam_postprocess`
a batch (the logits to the crop's size, stability and the filters, on the device),
`mask_records` a batch (the host part) and `mask_nms` a crop and once across crops;
every host read goes through a counted sync. The counter `sam.masks_kept` adds the
masks a call returns.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import product
from typing import Callable

import numpy as np
import torch
from scipy import ndimage

from langsplat_tpu_torch.device import resolve_device
from langsplat_tpu_torch.utils import tracing

EIGHT_CONNECTED = np.ones((3, 3), bool)


@dataclass
class AutoMaskConfig:
    points_per_side: int = 32
    pred_iou_thresh: float = 0.7
    box_nms_thresh: float = 0.7
    stability_score_thresh: float = 0.85
    stability_score_offset: float = 1.0
    crop_n_layers: int = 0          # 1 in the preprocessing CLI
    crop_overlap_ratio: float = 512 / 1500
    crop_nms_thresh: float = 0.7
    crop_n_points_downscale_factor: int = 1
    min_mask_region_area: int = 100
    points_per_batch: int = 64
    mask_threshold: float = 0.0


def build_point_grid(n_per_side: int) -> np.ndarray:
    """[n^2, 2] normalized (x, y) grid points in (0, 1) (SAM convention)."""
    offset = 1.0 / (2 * n_per_side)
    coords = np.linspace(offset, 1 - offset, n_per_side)
    gx, gy = np.meshgrid(coords, coords)
    return np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)


def stability_score(logits: torch.Tensor, mask_threshold: float,
                    offset: float) -> torch.Tensor:
    """[N] float64: the IoU of the masks at threshold +- offset (SAM's stability)."""
    def count(above):
        return above.flatten(1).view(torch.uint8).sum(-1, dtype=torch.int32)
    hi = count(logits > (mask_threshold + offset))
    lo = count(logits > (mask_threshold - offset))
    return hi.double() / torch.clamp(lo, min=1).double()


def mask_to_bbox(masks: torch.Tensor) -> torch.Tensor:
    """[K, 4] float64 XYWH boxes of [K, h, w] bool masks ((0, 0, 0, 0) when empty)."""
    rows, cols = masks.any(dim=2), masks.any(dim=1)

    def extent(hit):
        n = hit.shape[1]
        idx = torch.arange(n, device=hit.device)
        first = torch.where(hit, idx, n).amin(dim=1)
        last = torch.where(hit, idx, -1).amax(dim=1)
        return first, last - first + 1
    x0, w = extent(cols)
    y0, h = extent(rows)
    box = torch.stack([x0, y0, w, h], dim=1).double()
    return torch.where(masks.flatten(1).any(1)[:, None], box, 0.0)


def box_nms(boxes_xywh: torch.Tensor, scores: torch.Tensor, thresh: float) -> torch.Tensor:
    """Greedy IoU NMS on [N, 4] float64 XYWH boxes, scores [N] float64, visited in a
    stable descending order -> kept indices (int64)."""
    if len(boxes_xywh) == 0:
        return torch.zeros(0, dtype=torch.int64)
    x0, y0 = boxes_xywh[:, 0], boxes_xywh[:, 1]
    x1 = x0 + boxes_xywh[:, 2]
    y1 = y0 + boxes_xywh[:, 3]
    areas = (x1 - x0) * (y1 - y0)
    order = torch.sort(-scores, stable=True).indices
    keep = []
    while len(order):
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        xx0 = torch.maximum(x0[i], x0[rest])
        yy0 = torch.maximum(y0[i], y0[rest])
        xx1 = torch.minimum(x1[i], x1[rest])
        yy1 = torch.minimum(y1[i], y1[rest])
        inter = torch.clamp(xx1 - xx0, min=0) * torch.clamp(yy1 - yy0, min=0)
        iou = inter / torch.clamp(areas[i] + areas[rest] - inter, min=1e-9)
        order = rest[iou <= thresh]
    return torch.tensor(keep, dtype=torch.int64)


def generate_crop_boxes(im_size: tuple[int, int], n_layers: int,
                        overlap_ratio: float):
    """XYXY crop boxes per layer: layer 0 = the full image, layer i has (2^i)^2
    overlapping crops (upstream SAM's generate_crop_boxes)."""
    im_h, im_w = im_size
    boxes = [[0, 0, im_w, im_h]]
    layers = [0]
    short_side = min(im_h, im_w)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_per_side))
        cw = crop_len(im_w, n_per_side, overlap)
        ch = crop_len(im_h, n_per_side, overlap)
        x0s = [int((cw - overlap) * i) for i in range(n_per_side)]
        y0s = [int((ch - overlap) * i) for i in range(n_per_side)]
        for x0, y0 in product(x0s, y0s):
            boxes.append([x0, y0, min(x0 + cw, im_w), min(y0 + ch, im_h)])
            layers.append(i_layer + 1)
    return boxes, layers


def is_box_near_crop_edge(boxes_xywh: torch.Tensor, crop_box, orig_size,
                          atol: float = 20.0) -> torch.Tensor:
    """[K] bool: the (full-image) box touches the crop's boundary without touching the
    image's; such masks are clipped artifacts of the crop (upstream SAM)."""
    h, w = orig_size
    box = torch.cat([boxes_xywh[:, :2], boxes_xywh[:, :2] + boxes_xywh[:, 2:] - 1], 1)
    crop = torch.tensor(crop_box, dtype=torch.float64, device=box.device)
    orig = torch.tensor([0, 0, w, h], dtype=torch.float64, device=box.device)
    near_crop = torch.abs(box - crop) <= atol
    near_image = torch.abs(box - orig) <= atol
    return (near_crop & ~near_image).any(dim=1)


def _small_components(m: np.ndarray, min_area: int) -> np.ndarray:
    """The pixels of the 8-connected components of `m` with fewer than min_area px."""
    labels, n = ndimage.label(m, structure=EIGHT_CONNECTED)
    small = np.bincount(labels.ravel(), minlength=n + 1) < min_area
    small[0] = False
    return small[labels]


def _bbox(m: np.ndarray):
    """(y0, y1, x0, x1) of the mask's pixels, None when it has none."""
    rows, cols = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
    if len(rows) == 0:
        return None
    return rows[0], rows[-1] + 1, cols[0], cols[-1] + 1


def remove_small_regions(mask: np.ndarray, min_area: int) -> np.ndarray:
    """Drop the islands, then fill the holes, of fewer than min_area px (8-connected),
    as the JAX package's `cv2.connectedComponentsWithStats` pair does; a new mask."""
    m = np.array(mask, dtype=bool)
    _remove_small_regions_in_place(m, min_area, _bbox(m))
    return m


def _remove_small_regions_in_place(m: np.ndarray, min_area: int, box) -> None:
    """`remove_small_regions` on `m` itself, given its bounding box `box`.

    Only the box is labelled: islands lie inside it, and when the background outside
    it is one component (the box spans neither the full width nor the full height) of
    at least min_area px, a hole is a background component inside the box that does
    not reach the one-pixel ring around it. Otherwise the whole background is
    labelled."""
    if box is not None:
        y0, y1, x0, x1 = box
        win = m[y0:y1, x0:x1]
        win[_small_components(win, min_area)] = False
        inner = _bbox(win)
        box = None if inner is None else (y0 + inner[0], y0 + inner[1],
                                          x0 + inner[2], x0 + inner[3])
    h, w = m.shape
    if box is None:                      # the background is the one component
        if h * w < min_area:
            m[:] = True
        return
    y0, y1, x0, x1 = box
    if (y1 - y0 < h and x1 - x0 < w
            and h * w - (y1 - y0) * (x1 - x0) >= min_area):
        wy0, wy1, wx0, wx1 = max(y0 - 1, 0), min(y1 + 1, h), max(x0 - 1, 0), min(x1 + 1, w)
        labels, n = ndimage.label(~m[wy0:wy1, wx0:wx1], structure=EIGHT_CONNECTED)
        small = np.bincount(labels.ravel(), minlength=n + 1) < min_area
        ring = np.ones(labels.shape, bool)
        ring[y0 - wy0:y1 - wy0, x0 - wx0:x1 - wx0] = False
        small[labels[ring]] = False
        small[0] = False
        m[wy0:wy1, wx0:wx1][small[labels]] = True
    else:
        m[_small_components(~m, min_area)] = True


class AutoMaskGenerator:
    """generate(image [H, W, 3] uint8) -> (masks_default, masks_s, masks_m, masks_l),
    each a list of dicts with `segmentation` ([H, W] bool tensor on the device), `bbox`
    (XYWH float64), `predicted_iou`, `stability_score`, `point_coords`, `crop_box`.
    Runs on the CUDA card unless `device` says otherwise."""

    def __init__(self, predictor: Callable, config: AutoMaskConfig | None = None,
                 device=None):
        self.predictor = predictor
        self.config = config or AutoMaskConfig()
        self.device = resolve_device(device)

    @property
    def encodes_once(self) -> bool:
        return all(hasattr(self.predictor, m) for m in ("set_image", "decode", "upscale"))

    @tracing.traced("generate")
    def generate(self, image: np.ndarray):
        cfg = self.config
        h, w = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            (h, w), cfg.crop_n_layers, cfg.crop_overlap_ratio)

        per_head: list[list[dict]] = [[], [], [], []]
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            crop_heads = self._process_crop(image, crop_box, layer_idx, (h, w))
            for i in range(4):
                per_head[i].extend(crop_heads[i])

        out = []
        with tracing.span("mask_nms"):
            for recs in per_head:
                if recs and len(crop_boxes) > 1:
                    # cross-crop dedup preferring masks found in smaller crops
                    boxes = torch.as_tensor(np.stack([r["bbox"] for r in recs]))
                    areas = np.array([(r["crop_box"][2] - r["crop_box"][0])
                                      * (r["crop_box"][3] - r["crop_box"][1])
                                      for r in recs], np.float64)
                    keep = box_nms(boxes, torch.as_tensor(1.0 / areas),
                                   cfg.crop_nms_thresh)
                    recs = [recs[i] for i in sorted(keep.tolist())]
                out.append(recs)
        tracing.COUNTERS["sam.masks_kept"] += len({id(r) for recs in out for r in recs})
        return tuple(out)

    def _process_crop(self, image: np.ndarray, crop_box, layer_idx: int,
                      orig_size) -> list[list[dict]]:
        """The point grid over one crop; records in full-image coordinates, box-NMS'd
        per head."""
        cfg = self.config
        x0, y0, x1, y1 = crop_box
        crop = image[y0:y1, x0:x1]
        ch, cw = crop.shape[:2]
        n_pts = max(cfg.points_per_side
                    // (cfg.crop_n_points_downscale_factor ** layer_idx), 1)
        grid = build_point_grid(n_pts) * np.array([cw, ch])
        if self.encodes_once:
            with tracing.span("sam_encoder"):
                self.predictor.set_image(crop)

        per_head: list[list[dict]] = [[], [], [], []]
        for start in range(0, len(grid), cfg.points_per_batch):
            pts = grid[start:start + cfg.points_per_batch]
            for heads, rec in self._batch_records(crop, pts, crop_box, orig_size):
                for lst in heads:
                    per_head[lst].append(rec)

        out = []
        with tracing.span("mask_nms"):
            for recs in per_head:
                if recs:
                    boxes = torch.as_tensor(np.stack([r["bbox"] for r in recs]))
                    scores = torch.tensor([r["predicted_iou"] for r in recs],
                                          dtype=torch.float64)
                    keep = box_nms(boxes, scores, cfg.box_nms_thresh)
                    recs = [recs[i] for i in sorted(keep.tolist())]
                out.append(recs)
            # one tensor for the kept masks, so the batches' tensors are freed
            kept = list({id(r): r for recs in out for r in recs}.values())
            if kept:
                segs = torch.stack([r["segmentation"] for r in kept])
                for r, seg in zip(kept, segs):
                    r["segmentation"] = seg
        return out

    def _filter_batch(self, masks, iou_preds, logits):
        """The IoU, stability and empty-mask filters of one predictor call: (point
        indices, head indices, the surviving masks [K, h, w], their IoU predictions and
        stability scores, the best head of every point), in (point, head) order, on the
        device."""
        cfg = self.config
        dev = self.device
        masks = torch.as_tensor(masks, device=dev)
        iou_preds = torch.as_tensor(iou_preds, device=dev)
        logits = torch.as_tensor(logits, device=dev)
        ch, cw = masks.shape[-2:]
        stab = stability_score(logits.reshape(-1, ch, cw), cfg.mask_threshold,
                               cfg.stability_score_offset).reshape(iou_preds.shape)
        keep = (~(iou_preds < cfg.pred_iou_thresh)
                & ~(stab < cfg.stability_score_thresh) & masks.flatten(2).any(2))
        with tracing.synced("mask.filter"):
            p_idx, h_idx = keep.nonzero(as_tuple=True)     # row-major: points, heads
        return (p_idx, h_idx, masks[p_idx, h_idx], iou_preds[p_idx, h_idx],
                stab[p_idx, h_idx], iou_preds.argmax(dim=1))

    def _remove_small_regions(self, segs: np.ndarray) -> np.ndarray:
        """`remove_small_regions` of every mask of [K, h, w] bool (none empty) on the
        host, in place."""
        if self.config.min_mask_region_area > 0:
            for m in segs:
                _remove_small_regions_in_place(m, self.config.min_mask_region_area, _bbox(m))
        return segs

    def _batch_records(self, crop: np.ndarray, pts: np.ndarray, crop_box, orig_size):
        """[(head lists, record)] of one predictor call, in (point, head) order."""
        h, w = orig_size
        x0, y0, x1, y1 = crop_box
        if self.encodes_once:
            with tracing.span("sam_decoder"):
                low_res, iou_preds = self.predictor.decode(pts)
            with tracing.span("sam_postprocess"):
                logits = self.predictor.upscale(low_res)
                filtered = self._filter_batch(logits > self.config.mask_threshold,
                                              iou_preds, logits)
        else:
            masks, iou_preds, logits = self.predictor(crop, pts)
            with tracing.span("sam_postprocess"):
                filtered = self._filter_batch(masks, iou_preds, logits)
        del logits
        p_idx, h_idx, segs, ious, stabs, best_head = filtered
        if len(p_idx) == 0:
            return []
        with tracing.span("mask_records"):
            with tracing.synced("mask.records", 2):
                scalars = torch.cat([p_idx.double(), h_idx.double(), ious.double(), stabs,
                                     best_head.double()]).cpu().numpy()
                segs = segs.cpu().numpy()
            k = len(segs)
            p_idx, h_idx = scalars[:k].astype(np.int64), scalars[k:2 * k].astype(np.int64)
            ious, stabs, best = scalars[2 * k:3 * k], scalars[3 * k:4 * k], scalars[4 * k:]
            segs = self._remove_small_regions(segs)
            bbox = mask_to_bbox(torch.from_numpy(segs))
            bbox = bbox + torch.tensor([x0, y0, 0, 0], dtype=torch.float64)
            ok = torch.from_numpy(segs).flatten(1).any(1)
            cropped = (x0, y0, x1, y1) != (0, 0, w, h)
            if cropped:
                ok &= ~is_box_near_crop_edge(bbox, crop_box, orig_size)
            ok = ok.numpy()
            if not ok.any():
                return []
            kept = tracing.upload("mask.records.segs", segs[ok], device=self.device)
            if cropped:
                full = torch.zeros((len(kept), h, w), dtype=torch.bool, device=self.device)
                full[:, y0:y1, x0:x1] = kept
            else:
                full = kept
            bbox = bbox.numpy()[ok]
            out = []
            for k, (p, head, iou, stab) in enumerate(zip(
                    p_idx[ok].tolist(), h_idx[ok].tolist(), ious[ok].tolist(),
                    stabs[ok].tolist())):
                rec = {
                    "segmentation": full[k],
                    "bbox": bbox[k],
                    "predicted_iou": float(iou),
                    "stability_score": float(stab),
                    "point_coords": [[pts[p][0] + x0, pts[p][1] + y0]],
                    "crop_box": list(crop_box),
                }
                out.append(([head + 1, 0] if head == best[p] else [head + 1], rec))
        return out
