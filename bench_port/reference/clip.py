"""The plain reference of LangSplat's mask-to-embedding stage (the cell
embed.clip-vit-b16): the mask NMS, the CLIP tiles, the seg map and OpenCLIP ViT-B/16's
image tower.

Written from LangSplat's `preprocess.py` (`mask_nms` and `masks_update` :215-294,
`get_seg_img`, `pad_img` and `mask2segmap` :191-317, `_embed_clip_sam_tiles` :176-189)
and OpenCLIP's `VisionTransformer` as plain float32 tensor arithmetic with TF32 off:
one mask at a time for the tiles, one head at a time in the tower, the tiles through
the tower in blocks. It imports nothing of the program and takes nothing the program
made: it draws its weights again from the seed by the rule the program's SAM and CLIP
share (`weights`), under the program's names, and keeps, crops, pads, resizes, maps
and encodes again.

Departures from upstream's code, each deliberate:
- the scores (stability x predicted IoU) are sorted and thresholded in float64, as the
  preprocessing's JAX package and port compare them (upstream: float32 tensors);
- the pairwise intersections are one float64 product of the masks (exact counts), and
  upstream's pair loop (j >= i) is written as the same formulas over the [M, M] matrix;
- `cv2.resize(tile, (224, 224))` (INTER_LINEAR on uint8) is OpenCV's rule as
  `langsplat_tpu_torch/preprocess/masks.py`'s docstring states it: 11-bit fixed-point
  taps from (d + 1/2) scale - 1/2 in float32 (the x taps reset at both borders, the y
  rows clipped), the two horizontal taps summed in integers, the rows combined as
  ((r0 >> 4) b0 >> 16) + ((r1 >> 4) b1 >> 16), rounded by (+2) >> 2;
- uint8 -> [0, 1] is a table of x / 255 rounded once, as numpy divides;
- the tower runs in float32 (upstream builds it in fp16), 16 tiles a block;
- the patch embedding is a product of unfolded 16 x 16 x 3 patches.

`Arith` selects the arithmetic of the tower: `pr` rounds every stage's tensors
(`Precision`: "bfloat16" is the control); `tf32` lets its matrix products run as TF32,
a precision below the configuration's float32; `quick_gelu` puts x sigmoid(1.702 x)
(the OpenAI weights' activation) in place of the exact GELU, a fault.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.reference import FLOAT32, Precision
from bench_port.reference.sam import _Tf32, gelu, layer_norm, linear, mm, name_seed, softmax

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
TILE = 224                  # CLIP's input side, the tiles' side
COEF_SCALE = 2048           # OpenCV's INTER_RESIZE_COEF_SCALE
BLOCK = 16                  # tiles through the tower at a time
LEVELS = ("default", "s", "m", "l")


class Arith:
    def __init__(self, pr: Precision = FLOAT32, tf32: bool = False,
                 quick_gelu: bool = False):
        self.pr, self.tf32, self.quick_gelu = pr, tf32, quick_gelu


EXACT = Arith()


# ---------------------------------------------------------------------------
# Sizes and weights
# ---------------------------------------------------------------------------

def sizes(cfg: dict) -> dict:
    """The tower's sizes from a configuration file (OpenCLIP's `vision_cfg` keys)."""
    v = cfg["vision_cfg"]
    width = v["width"]
    return dict(image_size=v["image_size"], patch=v["patch_size"], width=width,
                layers=v["layers"], heads=width // v["head_width"],
                mlp=int(width * v["mlp_ratio"]), output=cfg["embed_dim"],
                grid=v["image_size"] // v["patch_size"], eps=cfg["layer_norm_eps"],
                act=cfg["act"])


def shapes(s: dict) -> dict:
    """Every weight's name (the program's) and shape."""
    d, m, p = s["width"], s["mlp"], s["patch"]
    out = {"patch_embed.weight": (d, 3, p, p), "class_embedding": (d,),
           "pos_embed": (s["grid"] ** 2 + 1, d),
           "ln_pre.weight": (d,), "ln_pre.bias": (d,)}
    for i in range(s["layers"]):
        b = f"blocks.{i}."
        out.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                    b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
                    b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                    b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                    b + "mlp.lin1.weight": (m, d), b + "mlp.lin1.bias": (m,),
                    b + "mlp.lin2.weight": (d, m), b + "mlp.lin2.bias": (d,)})
    out.update({"ln_post.weight": (d,), "ln_post.bias": (d,),
                "proj.weight": (s["output"], d)})
    return out


def weights(s: dict, seed: int, device) -> dict:
    """Each tensor a normal draw from a generator seeded by the run's seed and its name:
    1 + 0.1 N for a LayerNorm scale (a 1-D weight), 0.02 N for any other 1-D tensor,
    0.1 N for the position embedding, N / sqrt(fan-in) for the rest (fan-in: the
    product of the trailing sizes)."""
    out = {}
    for name, shape in shapes(s).items():
        gen = torch.Generator(device=device)
        gen.manual_seed(name_seed(seed, name))
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        if len(shape) == 1:
            x = 1.0 + 0.1 * x if name.endswith("weight") else 0.02 * x
        elif name.endswith("pos_embed"):
            x = 0.1 * x
        else:
            x = x / math.sqrt(math.prod(shape[1:]))
        out[name] = x
    return out


# ---------------------------------------------------------------------------
# The mask NMS (LangSplat `mask_nms`, `masks_update`)
# ---------------------------------------------------------------------------

def mask_nms(segs: torch.Tensor, scores: np.ndarray, iou_thr: float, score_thr: float,
             inner_thr: float) -> list[int]:
    """Indices (ascending, into the given order) of the [M, H, W] bool masks kept."""
    m = len(scores)
    order = sorted(range(m), key=lambda i: -float(scores[i]))     # stable, descending
    idx = torch.tensor(order, device=segs.device)
    flat = segs[idx].reshape(m, -1).double()
    inter = (flat @ flat.T).float()             # exact counts, then float32
    area = flat.sum(dim=1).float()
    del flat
    i, j = torch.meshgrid(torch.arange(m, device=segs.device),
                          torch.arange(m, device=segs.device), indexing="ij")
    pair = j >= i                                # upstream's loop: for j in range(i, M)
    union = area[:, None] + area[None, :] - inter
    iou = torch.where(pair, inter / union, 0.0)
    frac_i = inter / area[:, None]               # intersection / area of mask i
    frac_j = inter / area[None, :]
    inner_val = 1 - frac_j * frac_i
    upper = torch.where(pair & (frac_i < 0.5) & (frac_j >= 0.85), inner_val, 0.0)
    lower = torch.where(pair & (frac_i >= 0.85) & (frac_j < 0.5), inner_val, 0.0)
    inner = upper + lower.T                      # [i, j] and [j, i]
    iou_max = torch.triu(iou, diagonal=1).amax(dim=0)
    inner_max_u = torch.triu(inner, diagonal=1).amax(dim=0)
    inner_max_l = torch.tril(inner, diagonal=1).amax(dim=0)
    keep = iou_max <= iou_thr
    sorted_scores = torch.tensor([float(scores[k]) for k in order], dtype=torch.float64,
                                 device=segs.device)
    keep_conf = sorted_scores > score_thr
    keep_inner_u = inner_max_u <= 1 - inner_thr
    keep_inner_l = inner_max_l <= 1 - inner_thr
    for k in (keep_conf, keep_inner_u, keep_inner_l):
        if int(k.sum()) == 0:                    # the top 3 by score
            k[:3] = True
    keep = (keep & keep_conf & keep_inner_u & keep_inner_l).cpu().tolist()
    return sorted(order[r] for r in range(m) if keep[r])


def masks_update(levels: list[list[dict]], iou_thr: float = 0.8, score_thr: float = 0.7,
                 inner_thr: float = 0.5) -> list[list[int]]:
    """The kept indices of each level's records (score: stability x predicted IoU)."""
    out = []
    for recs in levels:
        if not recs:
            out.append([])
            continue
        segs = torch.stack([r["segmentation"] for r in recs])
        scores = np.array([r["stability_score"] * r["predicted_iou"] for r in recs])
        out.append(mask_nms(segs, scores, iou_thr, score_thr, inner_thr))
    return out


# ---------------------------------------------------------------------------
# Tiles and the seg map (LangSplat `get_seg_img`, `pad_img`, `mask2segmap`)
# ---------------------------------------------------------------------------

def _taps(n_in: int, n_out: int, border_reset: bool):
    """OpenCV's linear taps from n_in to n_out pixels: (first index, second index,
    first weight, second weight), each a list of n_out ints."""
    scale = 1.0 / (n_out / n_in)
    first, second, w0, w1 = [], [], [], []
    for d in range(n_out):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = int(math.floor(f))
        f = np.float32(f - np.float32(s))
        if border_reset:
            if s < 0:
                f, s = np.float32(0), 0
            if s >= n_in - 1:
                f, s = np.float32(0), n_in - 1
            s1 = min(s + 1, n_in - 1)
        else:
            s1 = min(max(s + 1, 0), n_in - 1)
            s = min(max(s, 0), n_in - 1)
        first.append(s)
        second.append(s1)
        w0.append(int(np.rint((np.float32(1) - f) * np.float32(COEF_SCALE))))
        w1.append(int(np.rint(f * np.float32(COEF_SCALE))))
    return first, second, w0, w1


def resize_linear(img: torch.Tensor, side: int) -> torch.Tensor:
    """`cv2.resize(img, (side, side))`, INTER_LINEAR, of a square [n, n, 3] uint8."""
    n, dev = img.shape[0], img.device
    x0, x1, a0, a1 = (torch.tensor(t, device=dev) for t in _taps(n, side, True))
    y0, y1, b0, b1 = (torch.tensor(t, device=dev) for t in _taps(n, side, False))
    src = img.long()
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]   # [n, side, 3]
    out = (((rows[y0] >> 4) * b0[:, None, None]) >> 16) \
        + (((rows[y1] >> 4) * b1[:, None, None]) >> 16)
    return torch.clamp((out + 2) >> 2, 0, 255).to(torch.uint8)


def tile(image: torch.Tensor, seg: torch.Tensor, bbox) -> torch.Tensor:
    """One mask's [224, 224, 3] uint8 tile: the image outside the mask zeroed, cropped
    to the box (XYWH, truncated to int32), padded to a centred square, resized."""
    x, y, w, h = (int(v) for v in np.int32(bbox))
    crop = (image * seg[..., None].to(image.dtype))[y:y + h, x:x + w]
    side = max(w, h)
    square = torch.zeros((side, side, 3), dtype=torch.uint8, device=image.device)
    if h > w:
        square[:, (h - w) // 2:(h - w) // 2 + w] = crop
    else:
        square[(w - h) // 2:(w - h) // 2 + h, :] = crop
    return resize_linear(square, TILE)


def tiles(image: torch.Tensor, recs: list[dict]) -> torch.Tensor:
    """[M, 3, 224, 224] float32 in [0, 1] of the records' tiles, one at a time."""
    unit = torch.tensor(np.arange(256, dtype=np.float32) / np.float32(255),
                        device=image.device)
    return torch.stack([unit[tile(image, r["segmentation"], r["bbox"]).long()]
                        .permute(2, 0, 1) for r in recs])


def seg_map(recs: list[dict], shape) -> torch.Tensor:
    """[H, W] int32: each pixel the index of the last record whose mask holds it, -1
    where none does."""
    out = torch.full(tuple(shape), -1, dtype=torch.int32, device=recs[0]["segmentation"].device)
    for k, r in enumerate(recs):
        out[r["segmentation"]] = k
    return out


# ---------------------------------------------------------------------------
# The image tower (OpenCLIP `VisionTransformer`)
# ---------------------------------------------------------------------------

def quick_gelu(x):
    return x / (1.0 + torch.exp(-1.702 * x))


def _block(x, w, i, s, ar):
    b = f"blocks.{i}."
    d, heads = s["width"], s["heads"]
    hd = d // heads
    y = layer_norm(x, w, b + "norm1", s["eps"])
    qkv = ar.pr(linear(y, w, b + "attn.qkv", ar))
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    outs = []
    for h in range(heads):
        sl = slice(h * hd, (h + 1) * hd)
        scores = mm(q[..., sl] * hd ** -0.5, k[..., sl].transpose(-1, -2), ar)
        outs.append(mm(ar.pr(softmax(scores)), v[..., sl], ar))
    x = ar.pr(x + linear(ar.pr(torch.cat(outs, dim=-1)), w, b + "attn.proj", ar))
    y = layer_norm(x, w, b + "norm2", s["eps"])
    act = quick_gelu if ar.quick_gelu else gelu
    hidden = ar.pr(act(linear(y, w, b + "mlp.lin1", ar)))
    return ar.pr(x + linear(hidden, w, b + "mlp.lin2", ar))


def _encode(w, s, t, ar):
    dev = t.device
    n, p, g, d = t.shape[0], s["patch"], s["grid"], s["width"]
    mean = torch.tensor(CLIP_MEAN, device=dev)[:, None, None]
    std = torch.tensor(CLIP_STD, device=dev)[:, None, None]
    pixels = ar.pr((t - mean) / std)
    # each 16x16x3 patch, in the kernel's (channel, row, column) order, times the kernel
    patches = pixels.reshape(n, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5).reshape(
        n, g * g, 3 * p * p)
    x = mm(patches, w["patch_embed.weight"].reshape(d, -1).T, ar)
    cls = w["class_embedding"].expand(n, 1, d)
    x = torch.cat([cls, x], dim=1) + w["pos_embed"]
    x = ar.pr(layer_norm(x, w, "ln_pre", s["eps"]))
    for i in range(s["layers"]):
        x = _block(x, w, i, s, ar)
    pooled = layer_norm(x[:, 0], w, "ln_post", s["eps"])
    return ar.pr(mm(pooled, w["proj.weight"].T, ar))


def encode(w: dict, s: dict, t: torch.Tensor, ar: Arith = EXACT) -> torch.Tensor:
    """[M, 3, 224, 224] tiles in [0, 1] -> [M, output] float32 embeddings, BLOCK tiles
    at a time."""
    with _Tf32(ar):
        return torch.cat([_encode(w, s, t[i:i + BLOCK], ar)
                          for i in range(0, len(t), BLOCK)])
