"""LERF open-vocabulary IoU + localization evaluation, PyTorch counterpart of
`langsplat_tpu/evaluation/iou_loc.py`.

The protocol: labelme GT parsing, per-prompt relevancy maps smoothed with a 30x30 mean
filter averaged 50/50 with the raw map, min-max normalization into [-1, 1] clipped to
[0, 1], a threshold at `mask_thresh` into a binary mask cleaned by a 7x7 majority (mode)
filter, best-of-levels selection by the smoothed maximum, and localization as the mean
filter's argmax inside a GT box.

The decoder, relevancy, filters, masks and IoU run as tensors on the caller's device
(the card, from the eval CLI); the GT parsing and the PNG writers stay on the host.
Neither OpenCV nor matplotlib is needed on this path:
  - `polygon_to_mask` fills as `cv2.fillPoly(mask, [int32 points], 1)` does, bit for
    bit (its 8-connected outline plus a scanline fill whose spans take the pixels from
    floor(xl + 1/2) to ceil(xr + 1/2) - 1, in exact integer arithmetic, with OpenCV's
    clipped edges and their outside parts projected onto the border);
  - `mean_filter_30` is `cv2.filter2D` with a 30x30 box (anchor 15: offsets -15..+14)
    and a reflect-101 border, summed in float64 and rounded to float32 (cv2 runs a
    kernel this size through a DFT: the two agree to ~1e-7, not bit for bit);
  - `mode_filter` is the JAX package's integral-image majority vote, bit for bit.
The mean filter runs once per (level, prompt) map and serves both the IoU and the
localization (the JAX package filters each map twice, with the same numbers).
"""

from __future__ import annotations

import glob
import json
import os
import time
from collections import defaultdict

import numpy as np
import torch

from langsplat_tpu_torch.device import resolve_device
from langsplat_tpu_torch.evaluation.relevancy import NEGATIVE_PROMPTS, get_max_across

# ---------------------------------------------------------------------------
# Ground truth (host)
# ---------------------------------------------------------------------------


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's `clipLine` to [0, w-1] x [0, h-1] (float64 steps truncated to ints):
    (inside, x1, y1, x2, y2)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _inside(w: int, h: int, *xy: int) -> bool:
    return all(0 <= x < w for x in xy[0::2]) and all(0 <= y < h for y in xy[1::2])


def _draw_line(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """OpenCV's 8-connected line (its LineIterator, left to right), clipped."""
    h, w = mask.shape
    if not _inside(w, h, x1, y1, x2, y2):
        inside, x1, y1, x2, y2 = _clip_line(w, h, x1, y1, x2, y2)
        if not inside:
            return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vertical = dy > dx
    if vertical:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = 1
        minor = err < 0
        err += 2 * dx * minor - 2 * dy
        if vertical:
            y += sy
            x += sx * minor
        else:
            x += sx
            y += sy * minor


def polygon_to_mask(img_shape, points_list) -> np.ndarray:
    """uint8 [H, W] mask of a labelme polygon, as `cv2.fillPoly(mask, [np.int32
    points], 1)` draws it in OpenCV 5.0, bit for bit: the points truncated to int32, the
    closed 8-connected outline, and an even-odd scanline fill. Each edge runs over rows
    [min y, max y); at row y it stands at u = x + 1/2 on its line, and a span between
    the k-th and (k+1)-th crossing (k even) covers the pixels floor(u_l) ..
    ceil(u_r) - 1, clipped to the image, in exact integer arithmetic.

    An edge with an end outside the image takes its line from OpenCV's `clipLine`
    (`_clip_line`, integer ends t0, t1):
      - when the clipped ends share a row, the line through (t0.x, y0) and (t1.x, y1);
      - when clipLine fails, the line through the ends it returns;
      - otherwise the line through t0 and t1, and on the rows beyond a clipped end, on
        the side of an original end that lies left of the image (x < 0) or right of it
        (x > W - 1), the edge is projected onto that border: u = 0 or u = W.
    """
    h, w = img_shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(points_list, dtype=np.int32)]
    mask = np.zeros((h, w), np.uint8)
    # per edge: first row, last row + 1, its line (ax, ay, bx, by), and the projection
    # above row `top` onto u = u_top and below row `bottom` onto u = u_bottom (-1: none)
    edges = []
    x0, y0 = pts[-1]
    for x1, y1 in pts:
        _draw_line(mask, x0, y0, x1, y1)
        if y0 != y1:
            line, proj = (x0, y0, x1, y1), (y0, -1, y1, -1)
            if not _inside(w, h, x0, y0, x1, y1):
                clipped, cx0, cy0, cx1, cy1 = _clip_line(w, h, x0, y0, x1, y1)
                if cy0 == cy1:
                    line = (cx0, y0, cx1, y1)
                else:
                    line = (cx0, cy0, cx1, cy1)
                    if clipped:
                        ends = [(cy0, _border(w, x0)), (cy1, _border(w, x1))]
                        if y1 < y0:
                            ends.reverse()
                        proj = ends[0] + ends[1]
            edges.append((min(y0, y1), max(y0, y1)) + line + proj)
        x0, y0 = x1, y1
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, np.int64)
    lo, hi = e[:, 0], e[:, 1]
    flip = e[:, 5] < e[:, 3]             # orient every line downwards
    ax, ay = np.where(flip, e[:, 4], e[:, 2]), np.where(flip, e[:, 5], e[:, 3])
    bx, by = np.where(flip, e[:, 2], e[:, 4]), np.where(flip, e[:, 3], e[:, 5])
    top, u_top, bottom, u_bottom = e[:, 6], e[:, 7], e[:, 8], e[:, 9]
    for y in range(max(int(lo.min()), 0), min(int(hi.max()), h)):
        act = (lo <= y) & (y < hi)
        if act.sum() < 2:
            continue
        # u = x + 1/2 at row y = num / den, exactly
        den = 2 * (by[act] - ay[act])
        num = ((2 * ax[act] + 1) * (by[act] - ay[act])
               + 2 * (y - ay[act]) * (bx[act] - ax[act]))
        for cut, u in ((y < top[act]) & (u_top[act] >= 0), u_top[act]), \
                      ((y > bottom[act]) & (u_bottom[act] >= 0), u_bottom[act]):
            num = np.where(cut, u * den, num)
        order = np.argsort(num / den, kind="stable")
        num, den = num[order], den[order]
        k = len(num) // 2
        left = num[0:2 * k:2] // den[0:2 * k:2]
        right = -((-num[1:2 * k:2]) // den[1:2 * k:2]) - 1
        for xl, xr in zip(left, right):
            if xl < w and xr >= 0:
                mask[y, max(xl, 0):min(xr, w - 1) + 1] = 1
    return mask


def _border(w: int, x: int) -> int:
    """The border an outside end projects onto: u = 0 left of the image, u = W right of
    it, -1 (none) for an end whose column is inside."""
    return 0 if x < 0 else w if x > w - 1 else -1


def stack_mask(mask_base, mask_add):
    mask = mask_base.copy()
    mask[mask_add != 0] = 1
    return mask


def eval_gt_lerfdata(json_folder: str):
    """Parse LERF labelme GT: (gt_ann {frame_idx: {label: {bboxes, mask}}}, (h, w),
    image_paths); frame_idx is the number in `frame_XXXXX` minus 1."""
    gt_json_paths = sorted(glob.glob(os.path.join(json_folder, "frame_*.json")))
    img_paths = sorted(glob.glob(os.path.join(json_folder, "frame_*.jpg")))
    gt_ann = {}
    h = w = 0
    for js_path in gt_json_paths:
        img_ann = defaultdict(dict)
        with open(js_path) as f:
            gt_data = json.load(f)
        h, w = gt_data["info"]["height"], gt_data["info"]["width"]
        idx = int(gt_data["info"]["name"].split("_")[-1].split(".jpg")[0]) - 1
        for prompt_data in gt_data["objects"]:
            label = prompt_data["category"]
            box = np.asarray(prompt_data["bbox"]).reshape(-1)
            mask = polygon_to_mask((h, w), prompt_data["segmentation"])
            if img_ann[label].get("mask", None) is not None:
                mask = stack_mask(img_ann[label]["mask"], mask)
                img_ann[label]["bboxes"] = np.concatenate(
                    [img_ann[label]["bboxes"].reshape(-1, 4), box.reshape(-1, 4)],
                    axis=0)
            else:
                img_ann[label]["bboxes"] = box
            img_ann[label]["mask"] = mask
        gt_ann[f"{idx}"] = dict(img_ann)
    return gt_ann, (h, w), img_paths


# ---------------------------------------------------------------------------
# Filters (device)
# ---------------------------------------------------------------------------


def mode_filter(mask: torch.Tensor, scale: int = 3) -> torch.Tensor:
    """Binary majority filter over the last two axes. Window rows are
    [max(0, i-scale), min(i+scale+1, h-1)) — the h-1 clamp leaves the last row and
    column out of interior windows, as the reference does; ties resolve to 0."""
    h, w = mask.shape[-2:]
    dev = mask.device
    ii = torch.zeros(mask.shape[:-2] + (h + 1, w + 1), dtype=torch.int64, device=dev)
    ii[..., 1:, 1:] = torch.cumsum(torch.cumsum(mask.to(torch.int64), dim=-2), dim=-1)
    i = torch.arange(h, device=dev)
    j = torch.arange(w, device=dev)
    r0 = torch.clamp_min(i - scale, 0)
    r1 = torch.maximum(torch.clamp_max(i + scale + 1, h - 1), r0)
    c0 = torch.clamp_min(j - scale, 0)
    c1 = torch.maximum(torch.clamp_max(j + scale + 1, w - 1), c0)
    r0, r1, c0, c1 = r0[:, None], r1[:, None], c0[None, :], c1[None, :]
    ones = ii[..., r1, c1] - ii[..., r0, c1] - ii[..., r1, c0] + ii[..., r0, c0]
    area = (r1 - r0) * (c1 - c0)
    out = (ones * 2 > area).to(mask.dtype)
    return torch.where(area > 0, out, mask)


def _reflect101(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source index of each padded position -before .. n+after-1 under reflect-101."""
    i = torch.arange(-before, n + after, device=device).abs()
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i >= n, period - i, i)


def mean_filter_30(x: torch.Tensor, scale: int = 30) -> torch.Tensor:
    """`cv2.filter2D(x, -1, ones((scale, scale)) / scale**2)` over the last two axes:
    a box correlation anchored at scale // 2 with a reflect-101 border, as box sums of
    float64 cumulative sums, rounded to float32."""
    h, w = x.shape[-2:]
    before = scale // 2
    after = scale - 1 - before
    rows = _reflect101(h, before, after, x.device)
    cols = _reflect101(w, before, after, x.device)
    padded = x.to(torch.float64)[..., rows, :][..., cols]
    s = torch.nn.functional.pad(torch.cumsum(torch.cumsum(padded, dim=-2), dim=-1),
                                (1, 0, 1, 0))
    box = (s[..., scale:, scale:] - s[..., :-scale, scale:] - s[..., scale:, :-scale]
           + s[..., :-scale, :-scale])
    return (box / (scale * scale)).to(torch.float32)


# ---------------------------------------------------------------------------
# The protocol (device)
# ---------------------------------------------------------------------------


def activate_stream(valid_map, img_ann: dict, positives: list[str], thresh: float = 0.5,
                    out_dir: str | None = None, rgb_img: np.ndarray | None = None,
                    avg: torch.Tensor | None = None):
    """Per-prompt IoU with best-of-levels selection.

    valid_map: [L, P, H, W] raw relevancy maps (`get_max_across`); `avg` is its mean
    filter when the caller has it already. With out_dir, writes the per-prompt heatmap /
    composited / chosen-mask PNGs. Returns (chosen_ious, chosen_levels,
    smoothed [L,P,H,W], masks [L,P,H,W] uint8).
    """
    valid_map = torch.as_tensor(valid_map)
    dev = valid_map.device
    n_head, n_prompt = valid_map.shape[:2]
    if avg is None:
        avg = mean_filter_30(valid_map)
    smoothed = 0.5 * (avg + valid_map)
    lo = smoothed.flatten(2).amin(dim=-1)[..., None, None]
    output = smoothed - lo
    output = output / (output.flatten(2).amax(dim=-1)[..., None, None] + 1e-9)
    output = output * (1.0 - (-1.0)) + (-1.0)
    output = torch.clamp(output, 0, 1)
    masks = mode_filter((output > thresh).to(torch.uint8))
    gt = torch.stack([torch.as_tensor(img_ann[p]["mask"]) for p in positives]).to(dev)
    pred, gt = masks.bool(), gt.bool()[None]
    inter = torch.sum(pred & gt, dim=(-2, -1))
    union = torch.sum(pred | gt, dim=(-2, -1))
    iou = torch.where(union > 0, inter.double() / union.clamp_min(1).double(), 0.0)
    levels = torch.argmax(smoothed.flatten(2).amax(dim=-1), dim=0)            # [P]
    chosen = iou.gather(0, levels[None])[0]
    chosen_iou_list = [float(v) for v in chosen.cpu()]
    chosen_lvl_list = [int(v) for v in levels.cpu()]

    if out_dir is not None:
        from langsplat_tpu_torch.evaluation import viz
        sm, mk = smoothed.cpu().numpy(), masks.cpu().numpy()
        for k in range(n_prompt):
            for i in range(n_head):
                viz.heatmap_png(sm[i, k], os.path.join(
                    out_dir, "heatmap", f"{positives[k]}_{i}.png"))
                if rgb_img is not None:
                    viz.composited_png(sm[i, k], rgb_img, os.path.join(
                        out_dir, "composited", f"{positives[k]}_{i}.png"))
            viz.save_mask(mk[chosen_lvl_list[k], k], os.path.join(
                out_dir, f"chosen_{positives[k]}.png"))
    return chosen_iou_list, chosen_lvl_list, smoothed, masks


def lerf_localization(valid_map, img_ann: dict, positives: list[str],
                      out_dir: str | None = None, rgb_img: np.ndarray | None = None,
                      avg: torch.Tensor | None = None) -> int:
    """Count of prompts whose mean-filtered maximum (on the level with the highest one)
    falls inside one of the prompt's GT boxes. With out_dir and rgb_img, writes the
    per-prompt localization figures."""
    valid_map = torch.as_tensor(valid_map)
    dev = valid_map.device
    n_head, n_prompt, h, w = valid_map.shape
    if avg is None:
        avg = mean_filter_30(valid_map)
    score = avg.flatten(2).amax(dim=-1)                        # [L, P]
    head = torch.argmax(score, dim=0)                           # [P]
    k_idx = torch.arange(n_prompt, device=dev)
    peak = avg[head, k_idx] == score[head, k_idx][:, None, None]   # [P, H, W]
    ys = torch.arange(h, dtype=torch.float64, device=dev)
    xs = torch.arange(w, dtype=torch.float64, device=dev)
    hits = []
    for k in range(n_prompt):
        hit = torch.zeros((), dtype=torch.bool, device=dev)
        for x1, y1, x2, y2 in np.asarray(img_ann[positives[k]]["bboxes"],
                                         np.float64).reshape(-1, 4):
            in_y = (ys >= min(y1, y2)) & (ys <= max(y1, y2))
            in_x = (xs >= min(x1, x2)) & (xs <= max(x1, x2))
            hit = hit | (peak[k] & in_y[:, None] & in_x[None, :]).any()
        hits.append(hit)
    acc_num = int(torch.stack(hits).sum()) if hits else 0

    if out_dir is not None and rgb_img is not None:
        from langsplat_tpu_torch.evaluation import viz
        from langsplat_tpu_torch.evaluation.colormaps import ColormapOptions, apply_colormap
        for k in range(n_prompt):
            sel = int(head[k])
            y0, x0 = (int(v) for v in torch.nonzero(peak[k])[0])
            relev = (0.5 * (avg[sel, k] + valid_map[sel, k])).cpu().numpy()
            p_i = np.clip(relev - 0.5, 0, 1)[..., None].astype(np.float32)
            composited = apply_colormap(p_i / (p_i.max() + 1e-6),
                                        ColormapOptions(colormap="turbo"))
            composited[relev < 0.5, :] = np.asarray(rgb_img)[relev < 0.5, :] * 0.3
            viz.localization_png(composited, np.array([x0, y0]),
                                 img_ann[positives[k]]["bboxes"],
                                 os.path.join(out_dir, "localization",
                                              f"{positives[k]}.png"))
    return acc_num


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eval_frame(sem_feat: np.ndarray, img_ann: dict, decode_fn, pos_embeds, neg_embeds,
               device, mask_thresh: float = 0.4, out_dir: str | None = None,
               rgb_img: np.ndarray | None = None) -> dict:
    """One frame of the protocol: decode the [L, H, W, 3] feature levels on `device`,
    score the frame's prompts, then IoU and localization. Returns the valid maps
    [L, P, H, W], the masks [L, P, H, W] and the smoothed maps' maxima [L, P] the IoUs
    were taken from, the chosen IoUs and levels, the localization count and each
    stage's host-clock ms (ending in a device synchronize)."""
    device = torch.device(device)
    lvl, h, w, c = sem_feat.shape
    positives = list(img_ann.keys())
    t0 = time.perf_counter()
    # float16 maps (as the quality protocol's oracle writes) decode in float32, as
    # flax's Dense promotes them in the JAX package
    restored = decode_fn(torch.as_tensor(sem_feat.reshape(-1, c)).to(device, torch.float32))
    restored = restored.reshape(lvl, h, w, -1)
    _sync(device)
    t1 = time.perf_counter()
    valid_map = get_max_across(restored, torch.as_tensor(pos_embeds).to(device),
                               torch.as_tensor(neg_embeds).to(device))
    del restored
    _sync(device)
    t2 = time.perf_counter()
    avg = mean_filter_30(valid_map)
    ious, lvls, smoothed, masks = activate_stream(valid_map, img_ann, positives, thresh=mask_thresh,
                                       out_dir=out_dir, rgb_img=rgb_img, avg=avg)
    _sync(device)
    t3 = time.perf_counter()
    acc = lerf_localization(valid_map, img_ann, positives, out_dir=out_dir,
                            rgb_img=rgb_img, avg=avg)
    _sync(device)
    t4 = time.perf_counter()
    ms = dict(decode_ms=(t1 - t0) * 1e3, relevancy_ms=(t2 - t1) * 1e3,
              filter_iou_ms=(t3 - t2) * 1e3, localization_ms=(t4 - t3) * 1e3)
    return dict(valid_map=valid_map, masks=masks, score=smoothed.flatten(2).amax(dim=-1),
                ious=ious, levels=lvls, acc=acc, **ms)


def load_frame_features(feat_dirs: list[str], idx: int) -> np.ndarray:
    """[L, H, W, C] rendered features of frame `idx` (files sorted by integer name)."""
    sem_feat = []
    for d in feat_dirs:
        paths = sorted(glob.glob(os.path.join(d, "*.npy")),
                       key=lambda p: int(os.path.basename(p).split(".npy")[0]))
        sem_feat.append(np.load(paths[idx]))
    return np.stack(sem_feat)


def evaluate(feat_dirs: list[str], json_folder: str, decode_fn, encode_text_fn,
             mask_thresh: float = 0.4, logger=print, output_path: str | None = None,
             device=None) -> dict:
    """The full evaluation, on the CUDA card unless `device` says otherwise (it raises
    without a card).

    Args:
      feat_dirs: one rendered-feature dir per level (renders_npy with [H,W,3] files).
      decode_fn: [N, 3] tensor -> [N, 512] tensor on `device` (the AE decoder).
      encode_text_fn: list[str] -> [K, 512] L2-normalized text embeddings.
      output_path: when given, per-frame visualization files go to
        `<output_path>/<idx+1:05d>/{heatmap,composited,localization,chosen_*}`.
    Returns {"miou", "localization_acc", "chosen_levels", "frames"}: "frames" holds,
    per GT frame, its index, IoUs, levels, localization count and stage times (ms).
    """
    device = resolve_device(device)
    gt_ann, (h, w), img_paths = eval_gt_lerfdata(json_folder)
    eval_idx = [int(i) for i in gt_ann.keys()]

    neg_embeds = np.asarray(encode_text_fn(list(NEGATIVE_PROMPTS)))
    chosen_iou_all, chosen_lvl_all, frames = [], [], []
    acc_num = 0
    for j, idx in enumerate(eval_idx):
        sem_feat = load_frame_features(feat_dirs, idx)
        img_ann = gt_ann[f"{idx}"]
        positives = list(img_ann.keys())
        pos_embeds = np.asarray(encode_text_fn(positives))

        out_dir = rgb_img = None
        if output_path is not None:
            out_dir = os.path.join(output_path, f"{idx + 1:0>5}")
            os.makedirs(out_dir, exist_ok=True)
            if j < len(img_paths):
                from PIL import Image
                rgb_img = np.asarray(Image.open(img_paths[j]).convert("RGB"),
                                     np.float32) / 255.0

        frame = eval_frame(sem_feat, img_ann, decode_fn, pos_embeds, neg_embeds, device,
                           mask_thresh=mask_thresh, out_dir=out_dir, rgb_img=rgb_img)
        for key in ("valid_map", "masks", "score"):
            del frame[key]
        chosen_iou_all.extend(frame["ious"])
        chosen_lvl_all.extend(frame["levels"])
        acc_num += frame["acc"]
        frames.append(dict(idx=idx, **frame))

    miou = float(np.mean(chosen_iou_all)) if chosen_iou_all else 0.0
    total_bboxes = sum(len(a) for a in gt_ann.values())
    acc = acc_num / total_bboxes if total_bboxes else 0.0
    logger(f"trunc thresh: {mask_thresh}")
    logger(f"iou chosen: {miou:.4f}")
    logger(f"Localization accuracy: {acc:.4f}")
    return {"miou": miou, "localization_acc": acc, "chosen_levels": chosen_lvl_all,
            "frames": frames}
