"""The plain reference of SAM ViT-H's automatic-mask path (the cell preprocess.sam-vit-h).

Written from segment-anything's published description (`modeling/image_encoder.py`,
`prompt_encoder.py`, `mask_decoder.py`, `transformer.py`, `utils/transforms.py`,
`utils/amg.py`, `predictor.py`) as plain float32 tensor arithmetic: one window and one
head at a time in the encoder, one prompt and one head at a time in the decoder. It
imports nothing of the program and takes nothing the program made: it draws its weights
again from the seed by the same rule (`weights`), under the same names, and resizes,
normalises, encodes, decodes and upsamples again.

Departures from upstream's code, each deliberate:
- the resize is PIL's bilinear uint8 resize (what upstream calls through torchvision)
  written out as dense float64 matrices of PIL's 22-bit fixed-point taps, exact;
- convolutions are matrix products of unfolded patches (a patch embedding of stride 16,
  1x1 and 3x3 convolutions, 2x2 transposed convolutions of stride 2);
- the bilinear upsampling of the logits (`F.interpolate`, align_corners=False) is a
  product with interpolation matrices on each side, their weights from PyTorch's rule
  for source indices, computed in float64 and rounded to float32;
- the model is prompted with single foreground points only (no box, no mask prompt);
- the global blocks attend one head at a time, so that a [4096, 4096] score matrix at a
  time fits beside the program's state.

`Arith` selects the arithmetic: `pr` rounds every stage's tensors (`Precision`:
"bfloat16" is the control); `tf32` lets matrix products run as TF32 (on the card its
tensor cores; on the CPU every product's operands rounded to TF32's 10 mantissa bits),
a precision below the configuration's float32; `global_rel_pos=False` leaves the global
blocks' relative-position term out, a fault.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_port.reference import FLOAT32, Precision

PIXEL_MEAN = (0.485, 0.456, 0.406)
PIXEL_STD = (0.229, 0.224, 0.225)
PRECISION_BITS = 22         # PIL's fixed point of resampling coefficients
ENCODER_EPS = 1e-6          # the ViT's LayerNorm
LN2D_EPS = 1e-6             # LayerNorm2d (the neck, the upscaling)
DECODER_EPS = 1e-5          # nn.LayerNorm's default, in the two-way transformer


class Arith:
    def __init__(self, pr: Precision = FLOAT32, tf32: bool = False,
                 global_rel_pos: bool = True):
        self.pr, self.tf32, self.global_rel_pos = pr, tf32, global_rel_pos


EXACT = Arith()


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to 10 mantissa bits (to nearest, ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _Tf32:
    """While open, the card's float32 matrix products and convolutions run as TF32
    exactly when `ar.tf32`; the flags are restored on exit."""

    def __init__(self, ar: Arith):
        self.on = ar.tf32

    def __enter__(self):
        flags = torch.backends.cuda.matmul, torch.backends.cudnn
        self.saved = [(f, f.allow_tf32) for f in flags]
        for f in flags:
            f.allow_tf32 = self.on

    def __exit__(self, *exc):
        for f, value in self.saved:
            f.allow_tf32 = value
        return False


def mm(a: torch.Tensor, b: torch.Tensor, ar: Arith) -> torch.Tensor:
    """a @ b in float32; as TF32 where `ar.tf32` (inside `_Tf32` on the card, operands
    rounded on the CPU)."""
    if ar.tf32 and not a.is_cuda:
        a, b = _round_tf32(a), _round_tf32(b)
    return a @ b


def linear(x, w, prefix, ar):
    return mm(x, w[prefix + ".weight"].T, ar) + w[prefix + ".bias"]


def layer_norm(x, w, prefix, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w[prefix + ".weight"] + w[prefix + ".bias"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def softmax(s):
    e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Sizes and weights
# ---------------------------------------------------------------------------

def sizes(cfg: dict) -> dict:
    """The model's sizes from a configuration file's keys."""
    s = {k: cfg[k] for k in (
        "image_size", "patch_size", "encoder_embed_dim", "encoder_depth",
        "encoder_num_heads", "window_size", "prompt_embed_dim", "decoder_depth",
        "decoder_num_heads", "decoder_mlp_dim", "attention_downsample_rate",
        "num_multimask_outputs", "iou_head_depth", "iou_head_hidden_dim")}
    s["global_attn_indexes"] = tuple(cfg["encoder_global_attn_indexes"])
    s["mlp_dim"] = int(cfg["encoder_embed_dim"] * cfg["mlp_ratio"])
    s["grid"] = cfg["image_size"] // cfg["patch_size"]
    return s


def shapes(s: dict) -> dict:
    """Every weight's name (segment-anything's) and shape."""
    d, g, m, c = s["encoder_embed_dim"], s["grid"], s["mlp_dim"], s["prompt_embed_dim"]
    hd, p = d // s["encoder_num_heads"], s["patch_size"]
    out = {"image_encoder.pos_embed": (1, g, g, d),
           "image_encoder.patch_embed.proj.weight": (d, 3, p, p),
           "image_encoder.patch_embed.proj.bias": (d,)}
    for i in range(s["encoder_depth"]):
        b = f"image_encoder.blocks.{i}."
        side = g if i in s["global_attn_indexes"] else s["window_size"]
        out.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                    b + "attn.rel_pos_h": (2 * side - 1, hd),
                    b + "attn.rel_pos_w": (2 * side - 1, hd),
                    b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
                    b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                    b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                    b + "mlp.lin1.weight": (m, d), b + "mlp.lin1.bias": (m,),
                    b + "mlp.lin2.weight": (d, m), b + "mlp.lin2.bias": (d,)})
    out.update({"image_encoder.neck.0.weight": (c, d, 1, 1),
                "image_encoder.neck.1.weight": (c,), "image_encoder.neck.1.bias": (c,),
                "image_encoder.neck.2.weight": (c, c, 3, 3),
                "image_encoder.neck.3.weight": (c,), "image_encoder.neck.3.bias": (c,),
                "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": (2, c // 2),
                "prompt_encoder.not_a_point_embed.weight": (1, c),
                "prompt_encoder.no_mask_embed.weight": (1, c),
                "mask_decoder.iou_token.weight": (1, c),
                "mask_decoder.mask_tokens.weight": (s["num_multimask_outputs"] + 1, c)})
    for i in range(4):
        out[f"prompt_encoder.point_embeddings.{i}.weight"] = (1, c)
    inner = c // s["attention_downsample_rate"]

    def attention(prefix, width):
        for n in ("q_proj", "k_proj", "v_proj"):
            out[f"{prefix}.{n}.weight"], out[f"{prefix}.{n}.bias"] = (width, c), (width,)
        out[f"{prefix}.out_proj.weight"], out[f"{prefix}.out_proj.bias"] = (c, width), (c,)

    t = "mask_decoder.transformer."
    for i in range(s["decoder_depth"]):
        b = f"{t}layers.{i}."
        attention(b + "self_attn", c)
        attention(b + "cross_attn_token_to_image", inner)
        attention(b + "cross_attn_image_to_token", inner)
        for n in range(1, 5):
            out[f"{b}norm{n}.weight"], out[f"{b}norm{n}.bias"] = (c,), (c,)
        out.update({b + "mlp.lin1.weight": (s["decoder_mlp_dim"], c),
                    b + "mlp.lin1.bias": (s["decoder_mlp_dim"],),
                    b + "mlp.lin2.weight": (c, s["decoder_mlp_dim"]),
                    b + "mlp.lin2.bias": (c,)})
    attention(t + "final_attn_token_to_image", inner)
    out[t + "norm_final_attn.weight"], out[t + "norm_final_attn.bias"] = (c,), (c,)
    u = "mask_decoder.output_upscaling."
    out.update({u + "0.weight": (c, c // 4, 2, 2), u + "0.bias": (c // 4,),
                u + "1.weight": (c // 4,), u + "1.bias": (c // 4,),
                u + "3.weight": (c // 4, c // 8, 2, 2), u + "3.bias": (c // 8,)})

    def mlp(prefix, dims):
        for j, (a, b) in enumerate(zip(dims, dims[1:])):
            out[f"{prefix}.layers.{j}.weight"], out[f"{prefix}.layers.{j}.bias"] = (b, a), (b,)

    tokens = s["num_multimask_outputs"] + 1
    for i in range(tokens):
        mlp(f"mask_decoder.output_hypernetworks_mlps.{i}", [c, c, c, c // 8])
    hidden = s["iou_head_hidden_dim"]
    mlp("mask_decoder.iou_prediction_head",
        [c] + [hidden] * (s["iou_head_depth"] - 1) + [tokens])
    return out


def name_seed(seed: int, name: str) -> int:
    h = seed % (1 << 61)
    for ch in name:
        h = (h * 1_000_003 + ord(ch)) % ((1 << 61) - 1)
    return h


def weights(s: dict, seed: int, device) -> dict:
    """Each tensor a normal draw from a generator seeded by the run's seed and its name:
    1 + 0.1 N for a LayerNorm scale (a 1-D weight), 0.02 N for a bias, N for the
    Fourier matrix, 0.1 N for the absolute position embedding, N / sqrt(fan-in) for the
    rest (fan-in: the product of the trailing sizes)."""
    out = {}
    for name, shape in shapes(s).items():
        gen = torch.Generator(device=device)
        gen.manual_seed(name_seed(seed, name))
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        if len(shape) == 1:
            x = 1.0 + 0.1 * x if name.endswith("weight") else 0.02 * x
        elif name.endswith("gaussian_matrix"):
            pass
        elif name.endswith("pos_embed"):
            x = 0.1 * x
        else:
            x = x / math.sqrt(math.prod(shape[1:]))
        out[name] = x
    return out


# ---------------------------------------------------------------------------
# Pre- and post-processing
# ---------------------------------------------------------------------------

def crop_boxes(h: int, w: int, n_layers: int, overlap_ratio: float) -> list:
    """XYXY crops (amg.py `generate_crop_boxes`): the image, then (2^i)^2 overlapping
    crops for each layer i."""
    boxes = [[0, 0, w, h]]
    short = min(h, w)
    for i in range(n_layers):
        n = 2 ** (i + 1)
        overlap = int(overlap_ratio * short * (2 / n))
        cw = int(math.ceil((overlap * (n - 1) + w) / n))
        ch = int(math.ceil((overlap * (n - 1) + h) / n))
        for x0 in [int((cw - overlap) * k) for k in range(n)]:
            for y0 in [int((ch - overlap) * k) for k in range(n)]:
                boxes.append([x0, y0, min(x0 + cw, w), min(y0 + ch, h)])
    return boxes


def point_grid(n: int) -> np.ndarray:
    """[n^2, 2] (x, y) in (0, 1), rows of x (amg.py `build_point_grid`)."""
    offset = 1 / (2 * n)
    c = np.linspace(offset, 1 - offset, n)
    return np.stack([np.tile(c[None, :], (n, 1)), np.tile(c[:, None], (1, n))],
                    axis=-1).reshape(-1, 2)


def _pil_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] float64: PIL's fixed-point bilinear weights, one row a pixel."""
    scale = n_in / n_out
    fs = max(scale, 1.0)
    m = torch.zeros((n_out, n_in), dtype=torch.float64)
    for o in range(n_out):
        centre = (o + 0.5) * scale
        lo = max(int(centre - fs + 0.5), 0)
        hi = min(int(centre + fs + 0.5), n_in)
        taps = [max(0.0, 1.0 - abs((x - centre + 0.5) * (1.0 / fs))) for x in range(lo, hi)]
        total = sum(taps)
        for x, t in zip(range(lo, hi), taps):
            t = t / total if total != 0 else t
            m[o, x] = int(t * (1 << PRECISION_BITS) + (0.5 if t >= 0 else -0.5))
    return m.to(device)


def resize_uint8(img: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """[h, w, 3] uint8 -> [oh, ow, 3] uint8 as PIL's BILINEAR: columns, rounded to
    uint8, then rows."""
    def fixed(v):
        return torch.clamp(torch.floor((v + (1 << (PRECISION_BITS - 1)))
                                       / (1 << PRECISION_BITS)), 0, 255)
    h, w = img.shape[:2]
    if (h, w) == (oh, ow):
        return img
    x = img.double()
    kx, ky = _pil_matrix(w, ow, img.device), _pil_matrix(h, oh, img.device)
    x = fixed(torch.einsum("hwc,ow->hoc", x, kx))
    return fixed(torch.einsum("hwc,oh->owc", x, ky)).to(torch.uint8)


def input_size(h: int, w: int, longest: int) -> tuple[int, int]:
    scale = longest * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _interp_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in]: bilinear weights, align_corners=False (source index (i + 0.5)
    n_in / n_out - 0.5, clamped at 0)."""
    m = torch.zeros((n_out, n_in), dtype=torch.float64)
    scale = n_in / n_out
    for i in range(n_out):
        src = max((i + 0.5) * scale - 0.5, 0.0)
        i0 = int(src)
        i1 = min(i0 + 1, n_in - 1)
        frac = src - i0
        m[i, i0] += 1.0 - frac
        m[i, i1] += frac
    return m.to(torch.float32).to(device)


def upscale(low: torch.Tensor, s: dict, in_size, crop_size, ar: Arith = EXACT):
    """[P, 3, 4g, 4g] -> [P, 3, h, w] logits: to the padded input's size, cropped to
    the resized input, then to the crop's size."""
    with _Tf32(ar):
        return _upscale(low, s, in_size, crop_size, ar)


def _upscale(low, s, in_size, crop_size, ar):
    dev, side = low.device, s["image_size"]
    a = _interp_matrix(low.shape[-1], side, dev)
    ry, rx = a[:in_size[0]], a[:in_size[1]]
    by = _interp_matrix(in_size[0], crop_size[0], dev)
    bx = _interp_matrix(in_size[1], crop_size[1], dev)
    out = torch.empty((*low.shape[:2], *crop_size), dtype=torch.float32, device=dev)
    for p in range(low.shape[0]):
        for k in range(low.shape[1]):
            padded = mm(mm(ry, low[p, k], ar), rx.T, ar)
            out[p, k] = mm(mm(by, padded, ar), bx.T, ar)
    return ar.pr(out)


# ---------------------------------------------------------------------------
# Image encoder
# ---------------------------------------------------------------------------

def _attention(x, w, prefix, side_h, side_w, heads, ar, rel_pos: bool):
    """[n, D] tokens of an side_h x side_w grid -> [n, D]; one head at a time."""
    n, d = x.shape
    hd = d // heads
    qkv = ar.pr(linear(x, w, prefix + ".qkv", ar))
    q, k, v = qkv[:, :d], qkv[:, d:2 * d], qkv[:, 2 * d:]
    rows = torch.arange(n, device=x.device) // side_w
    cols = torch.arange(n, device=x.device) % side_w
    off_h = rows[:, None] - rows[None, :] + side_h - 1
    off_w = cols[:, None] - cols[None, :] + side_w - 1
    outs = []
    for h in range(heads):
        sl = slice(h * hd, (h + 1) * hd)
        qh, kh, vh = q[:, sl], k[:, sl], v[:, sl]
        scores = mm(qh * hd ** -0.5, kh.T, ar)
        if rel_pos:
            # q . R_h[row offset] + q . R_w[column offset]
            scores = scores + torch.gather(mm(qh, w[prefix + ".rel_pos_h"].T, ar), 1, off_h)
            scores = scores + torch.gather(mm(qh, w[prefix + ".rel_pos_w"].T, ar), 1, off_w)
        outs.append(mm(ar.pr(softmax(scores)), vh, ar))
    return linear(ar.pr(torch.cat(outs, dim=1)), w, prefix + ".proj", ar)


def _block(t, w, i, s, ar):
    b = f"image_encoder.blocks.{i}."
    g, d = t.shape[0], t.shape[2]
    y = layer_norm(t, w, b + "norm1", ENCODER_EPS)
    heads = s["encoder_num_heads"]
    if i in s["global_attn_indexes"]:
        a = _attention(y.reshape(g * g, d), w, b + "attn", g, g, heads, ar,
                       ar.global_rel_pos).reshape(g, g, d)
    else:
        win = s["window_size"]
        side = -(-g // win) * win
        padded = torch.zeros((side, side, d), dtype=t.dtype, device=t.device)
        padded[:g, :g] = y
        out = torch.empty_like(padded)
        for y0 in range(0, side, win):
            for x0 in range(0, side, win):
                tokens = padded[y0:y0 + win, x0:x0 + win].reshape(win * win, d)
                out[y0:y0 + win, x0:x0 + win] = _attention(
                    tokens, w, b + "attn", win, win, heads, ar, True).reshape(win, win, d)
        a = out[:g, :g]
    t = ar.pr(t + a)
    y = layer_norm(t, w, b + "norm2", ENCODER_EPS)
    hidden = ar.pr(gelu(linear(y, w, b + "mlp.lin1", ar)))
    return ar.pr(t + linear(hidden, w, b + "mlp.lin2", ar))


def embed(w: dict, s: dict, image: torch.Tensor, ar: Arith = EXACT):
    """[h, w, 3] uint8 crop -> (embedding [C, g, g], the resized input's (h, w))."""
    with _Tf32(ar):
        return _embed(w, s, image, ar)


def _embed(w, s, image, ar):
    dev = image.device
    size, p, g = s["image_size"], s["patch_size"], s["grid"]
    ih, iw = input_size(image.shape[0], image.shape[1], size)
    x = resize_uint8(image, ih, iw).permute(2, 0, 1).double() * (1 / 255)
    mean = torch.tensor(PIXEL_MEAN, device=dev)[:, None, None]
    std = torch.tensor(PIXEL_STD, device=dev)[:, None, None]
    pixels = torch.zeros((3, size, size), dtype=torch.float32, device=dev)
    pixels[:, :ih, :iw] = (x.float() - mean) / std
    pixels = ar.pr(pixels)
    d = s["encoder_embed_dim"]
    # the patch embedding: each 16x16x3 patch times the kernel
    patches = pixels.reshape(3, g, p, g, p).permute(1, 3, 0, 2, 4).reshape(g * g, -1)
    kernel = w["image_encoder.patch_embed.proj.weight"].reshape(d, -1)
    t = mm(patches, kernel.T, ar) + w["image_encoder.patch_embed.proj.bias"]
    t = ar.pr(t.reshape(g, g, d) + w["image_encoder.pos_embed"][0])
    for i in range(s["encoder_depth"]):
        t = _block(t, w, i, s, ar)
    c = s["prompt_embed_dim"]
    n = "image_encoder.neck."
    x = mm(t.reshape(g * g, d), w[n + "0.weight"].reshape(c, d).T, ar)
    x = layer_norm(x, w, n + "1", LN2D_EPS).reshape(g, g, c)
    padded = torch.zeros((g + 2, g + 2, c), dtype=x.dtype, device=dev)
    padded[1:-1, 1:-1] = x
    # 3x3 patches in the kernel's (channel, row, column) order
    cols = torch.stack([padded[ky:ky + g, kx:kx + g] for ky in range(3) for kx in range(3)],
                       dim=-1).reshape(g * g, c * 9)
    x = mm(cols, w[n + "2.weight"].reshape(c, c * 9).T, ar)
    x = layer_norm(x, w, n + "3", LN2D_EPS)
    return ar.pr(x.T.reshape(c, g, g)), (ih, iw)


# ---------------------------------------------------------------------------
# Prompt encoder and mask decoder
# ---------------------------------------------------------------------------

def _fourier(coords: torch.Tensor, w: dict) -> torch.Tensor:
    """[..., 2] in [0, 1] -> [..., C]: sin and cos of 2 pi (2 x - 1) G."""
    z = 2 * math.pi * ((2 * coords - 1)
                       @ w["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"])
    return torch.cat([torch.sin(z), torch.cos(z)], dim=-1)


def _dec_attention(q, k, v, w, prefix, heads, ar):
    qp, kp, vp = (linear(q, w, prefix + ".q_proj", ar), linear(k, w, prefix + ".k_proj", ar),
                  linear(v, w, prefix + ".v_proj", ar))
    hd = qp.shape[1] // heads
    outs = []
    for h in range(heads):
        sl = slice(h * hd, (h + 1) * hd)
        scores = mm(qp[:, sl], kp[:, sl].T, ar) / math.sqrt(hd)
        outs.append(mm(softmax(scores), vp[:, sl], ar))
    return linear(torch.cat(outs, dim=1), w, prefix + ".out_proj", ar)


def _mlp(x, w, prefix, depth, ar):
    for j in range(depth):
        x = linear(x, w, f"{prefix}.layers.{j}", ar)
        if j < depth - 1:
            x = torch.relu(x)
    return x


def _conv_t2x2(x, w, prefix, ar):
    """[H, W, Cin] -> [2H, 2W, Cout]: out[2y + dy, 2x + dx] = x[y, x] . W[:, :, dy, dx]."""
    h, wd, cin = x.shape
    kernel = w[prefix + ".weight"]                          # [Cin, Cout, 2, 2]
    cout = kernel.shape[1]
    y = mm(x.reshape(h * wd, cin), kernel.reshape(cin, cout * 4), ar)
    y = y.reshape(h, wd, cout, 2, 2).permute(0, 3, 1, 4, 2).reshape(2 * h, 2 * wd, cout)
    return y + w[prefix + ".bias"]


def decode(w: dict, s: dict, emb: torch.Tensor, points: np.ndarray, crop_size, in_size,
           ar: Arith = EXACT):
    """One foreground point a prompt, one prompt at a time: points [P, 2] in the crop's
    pixels -> (low-res logits [P, 3, 4g, 4g], IoU predictions [P, 3])."""
    with _Tf32(ar):
        return _decode(w, s, emb, points, crop_size, in_size, ar)


def _decode(w, s, emb, points, crop_size, in_size, ar):
    dev = emb.device
    c, g, heads = s["prompt_embed_dim"], s["grid"], s["decoder_num_heads"]
    scale = np.array([in_size[1] / crop_size[1], in_size[0] / crop_size[0]])
    pts = torch.tensor(np.asarray(points, np.float64) * scale, dtype=torch.float32,
                       device=dev)
    centres = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    grid = torch.stack(torch.meshgrid(centres, centres, indexing="xy"), dim=-1)
    image_pe = _fourier(grid, w).reshape(g * g, c)
    image = emb.reshape(c, g * g).T + w["prompt_encoder.no_mask_embed.weight"]
    out_tokens = torch.cat([w["mask_decoder.iou_token.weight"],
                            w["mask_decoder.mask_tokens.weight"]])
    n_masks = out_tokens.shape[0] - 1
    t = "mask_decoder.transformer."
    lows, ious = [], []
    for p in range(len(pts)):
        point = _fourier((pts[p] + 0.5) / s["image_size"], w) \
            + w["prompt_encoder.point_embeddings.1.weight"][0]
        pad = w["prompt_encoder.not_a_point_embed.weight"][0]
        tokens = torch.cat([out_tokens, point[None], pad[None]])
        queries, keys = tokens, image
        for i in range(s["decoder_depth"]):
            b = f"{t}layers.{i}."
            if i == 0:
                queries = _dec_attention(queries, queries, queries, w, b + "self_attn",
                                         heads, ar)
            else:
                q = queries + tokens
                queries = queries + _dec_attention(q, q, queries, w, b + "self_attn",
                                                   heads, ar)
            queries = layer_norm(queries, w, b + "norm1", DECODER_EPS)
            attn = _dec_attention(queries + tokens, keys + image_pe, keys, w,
                                  b + "cross_attn_token_to_image", heads, ar)
            queries = layer_norm(queries + attn, w, b + "norm2", DECODER_EPS)
            hidden = torch.relu(linear(queries, w, b + "mlp.lin1", ar))
            queries = layer_norm(queries + linear(hidden, w, b + "mlp.lin2", ar), w,
                                 b + "norm3", DECODER_EPS)
            attn = _dec_attention(keys + image_pe, queries + tokens, queries, w,
                                  b + "cross_attn_image_to_token", heads, ar)
            keys = ar.pr(layer_norm(keys + attn, w, b + "norm4", DECODER_EPS))
            queries = ar.pr(queries)
        attn = _dec_attention(queries + tokens, keys + image_pe, keys, w,
                              t + "final_attn_token_to_image", heads, ar)
        queries = layer_norm(queries + attn, w, t + "norm_final_attn", DECODER_EPS)
        u = "mask_decoder.output_upscaling."
        up = layer_norm(_conv_t2x2(keys.reshape(g, g, c), w, u + "0", ar), w, u + "1",
                        LN2D_EPS)
        up = gelu(_conv_t2x2(gelu(up), w, u + "3", ar))         # [4g, 4g, C/8]
        hyper = torch.stack([
            _mlp(queries[1 + i], w, f"mask_decoder.output_hypernetworks_mlps.{i}", 3, ar)
            for i in range(n_masks)])
        masks = mm(hyper, up.reshape(16 * g * g, -1).T, ar).reshape(n_masks, 4 * g, 4 * g)
        iou = _mlp(queries[0], w, "mask_decoder.iou_prediction_head", s["iou_head_depth"],
                   ar)
        lows.append(masks[1:])
        ious.append(iou[1:])
    return ar.pr(torch.stack(lows)), ar.pr(torch.stack(ious))
