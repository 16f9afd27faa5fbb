"""Segment Anything (SAM) in plain PyTorch: the image encoder, the prompt encoder and
the mask decoder of facebookresearch/segment-anything (`modeling/image_encoder.py`,
`prompt_encoder.py`, `mask_decoder.py`, `transformer.py`), with their parameter names,
and the pre- and post-processing of its predictor.

`SamConfig()` is SAM ViT-H (`build_sam.py build_sam_vit_h`): a 16x16 patch embedding of
a 1024^2 input to 1280 channels, 32 pre-norm blocks of 16 heads of 80 with a GELU MLP of
5120 and the decomposed relative-position term, blocks 7, 15, 23 and 31 global over the
64x64 tokens and the rest inside 14x14 windows (the grid padded to 70x70), a neck to
256 channels; a random-Fourier prompt encoder; a two-way transformer of depth 2 at width
256 (8 heads, MLP 2048, cross-attention at half width), the upscaling 256 -> 64 -> 32,
four hypernetwork MLPs, an IoU head of depth 3, multimask outputs 1-3.

Everything runs in float32 without TF32 (`exact_float32`): upstream computes so, and the
mask thresholds at logit 0 and +-1 read what TF32's 10 mantissa bits would move.

Weights come from a `facebook/sam-vit-huge`-layout directory (`load_sam`: its
`config.json` and `model.safetensors` or `pytorch_model.bin`, through `hf_key`) or from
a seed (`random_state`, by the per-tensor rule of `seeded_state`). The model holds no
mask prompt (`mask_downscaling`): the automatic mask generator prompts with single
points alone.

The input image is resized by `resize_bilinear_uint8`, PIL's bilinear resize of a uint8
image (what upstream's `ResizeLongestSide` and the `transformers` processor call), bit
for bit: coefficients in 22-bit fixed point, the horizontal pass rounded to uint8 before
the vertical one.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from langsplat_tpu_torch.utils import tracing

#: SAM's pixel normalisation, on the [0, 1] scale (ImageNet's)
PIXEL_MEAN = (0.485, 0.456, 0.406)
PIXEL_STD = (0.229, 0.224, 0.225)
#: a mask is the logits above this
MASK_THRESHOLD = 0.0
#: PIL's fixed-point precision of resampling coefficients (Resample.c PRECISION_BITS)
PIL_PRECISION_BITS = 22


@dataclass(frozen=True)
class SamConfig:
    """SAM's sizes; the defaults are ViT-H's. `decoder_norm_eps` is the two-way blocks'
    LayerNorm epsilon: upstream's nn.LayerNorm default, 1e-6 in `transformers`'
    checkpoints."""
    image_size: int = 1024
    patch_size: int = 16
    encoder_width: int = 1280
    encoder_depth: int = 32
    encoder_heads: int = 16
    encoder_mlp_dim: int = 5120
    window_size: int = 14
    global_attn_indexes: tuple = (7, 15, 23, 31)
    encoder_norm_eps: float = 1e-6
    prompt_width: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    decoder_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def from_hf(cls, config: dict) -> "SamConfig":
        """The sizes of a `transformers` SamConfig's `config.json`."""
        v, d = config["vision_config"], config["mask_decoder_config"]
        if d["hidden_size"] != v["output_channels"]:
            raise ValueError("the decoder's width must equal the neck's channels")
        mlp = v.get("mlp_dim") or int(v["hidden_size"] * v.get("mlp_ratio", 4.0))
        return cls(image_size=v["image_size"], patch_size=v["patch_size"],
                   encoder_width=v["hidden_size"], encoder_depth=v["num_hidden_layers"],
                   encoder_heads=v["num_attention_heads"], encoder_mlp_dim=mlp,
                   window_size=v["window_size"],
                   global_attn_indexes=tuple(v["global_attn_indexes"]),
                   encoder_norm_eps=v.get("layer_norm_eps", 1e-6),
                   prompt_width=d["hidden_size"], decoder_depth=d["num_hidden_layers"],
                   decoder_heads=d["num_attention_heads"], decoder_mlp_dim=d["mlp_dim"],
                   attention_downsample_rate=d.get("attention_downsample_rate", 2),
                   num_multimask_outputs=d.get("num_multimask_outputs", 3),
                   iou_head_depth=d.get("iou_head_depth", 3),
                   iou_head_hidden_dim=d.get("iou_head_hidden_dim", 256),
                   decoder_norm_eps=d.get("layer_norm_eps", 1e-6))


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products and convolutions without TF32, restored on exit."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


# ---------------------------------------------------------------------------
# Image encoder
# ---------------------------------------------------------------------------

class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of [B, C, H, W] (upstream `common.LayerNorm2d`)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, act: type[nn.Module]):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)
        self.act = act()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


def rel_pos_table(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """[size, size, C]: the relative-position embedding of every (query, key) offset
    along one axis of equal query and key sizes (upstream `get_rel_pos`)."""
    if rel_pos.shape[0] != 2 * size - 1:
        raise ValueError(f"a table of {rel_pos.shape[0]} offsets for a side of {size}")
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + (size - 1)]


class Attention(nn.Module):
    """Multi-head attention over an [B, H, W, C] grid with the decomposed relative
    position term q.R_h + q.R_w added to the scaled scores (upstream `Attention`)."""

    def __init__(self, dim: int, heads: int, side: int):
        super().__init__()
        self.heads = heads
        head_dim = dim // heads
        self.scale = head_dim ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * side - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * side - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * self.heads, h * w, -1).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        r_q = q.reshape(b * self.heads, h, w, -1)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rel_pos_table(h, self.rel_pos_h))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rel_pos_table(w, self.rel_pos_w))
        grid = attn.view(b * self.heads, h, w, h, w)
        grid.add_(rel_h[:, :, :, :, None]).add_(rel_w[:, :, :, None, :])
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(b, self.heads, h, w, -1).permute(0, 2, 3, 1, 4)
        return self.proj(x.reshape(b, h, w, -1))


def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] zero-padded to multiples of `window` -> ([B * windows, window,
    window, C], (padded H, padded W))."""
    b, h, w, c = x.shape
    pad_h, pad_w = (window - h % window) % window, (window - w % window) % window
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, padded, size) -> torch.Tensor:
    hp, wp = padded
    h, w = size
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :].contiguous()


class Block(nn.Module):
    """x + attn(LN(x)), then x + MLP(LN(x)); windowed when `window` > 0."""

    def __init__(self, cfg: SamConfig, window: int):
        super().__init__()
        dim = cfg.encoder_width
        self.norm1 = nn.LayerNorm(dim, eps=cfg.encoder_norm_eps)
        self.attn = Attention(dim, cfg.encoder_heads, window or cfg.grid)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.encoder_norm_eps)
        self.mlp = MLPBlock(dim, cfg.encoder_mlp_dim, nn.GELU)
        self.window = window

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window > 0:
            size = x.shape[1:3]
            x, padded = window_partition(x, self.window)
        x = self.attn(x)
        if self.window > 0:
            x = window_unpartition(x, self.window, padded, size)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.encoder_width, kernel_size=cfg.patch_size,
                              stride=cfg.patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoder(nn.Module):
    """[B, 3, S, S] normalised pixels -> [B, prompt_width, S/16, S/16] embeddings."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, cfg.encoder_width))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size)
            for i in range(cfg.encoder_depth))
        out = cfg.prompt_width
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.encoder_width, out, kernel_size=1, bias=False), LayerNorm2d(out),
            nn.Conv2d(out, out, kernel_size=3, padding=1, bias=False), LayerNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# Prompt encoder
# ---------------------------------------------------------------------------

class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding of coordinates in [0, 1]^2."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        coords = (2 * coords - 1) @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def grid(self, size: int) -> torch.Tensor:
        """[C, size, size]: the encoding of every cell centre of a size^2 grid."""
        ones = torch.ones((size, size), device=self.positional_encoding_gaussian_matrix.device)
        y = (ones.cumsum(dim=0) - 0.5) / size
        x = (ones.cumsum(dim=1) - 0.5) / size
        return self.encode(torch.stack([x, y], dim=-1)).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        dim = cfg.prompt_width
        self.cfg = cfg
        self.pe_layer = PositionEmbeddingRandom(dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, dim)
        self.no_mask_embed = nn.Embedding(1, dim)

    def forward(self, points: torch.Tensor, labels: torch.Tensor):
        """points [B, N, 2] in the input frame's pixels, labels [B, N] (1 foreground,
        0 background) -> (sparse [B, N + 1, C] with the padding point, dense [B, C, g,
        g])."""
        b = points.shape[0]
        points = torch.cat([points + 0.5, points.new_zeros(b, 1, 2)], dim=1)
        labels = torch.cat([labels, labels.new_full((b, 1), -1)], dim=1)
        emb = self.pe_layer.encode(points / self.cfg.image_size)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight, emb)
        emb = torch.where(lab == 0, emb + self.point_embeddings[0].weight, emb)
        emb = torch.where(lab == 1, emb + self.point_embeddings[1].weight, emb)
        g = self.cfg.grid
        dense = self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(b, -1, g, g)
        return emb, dense


# ---------------------------------------------------------------------------
# Mask decoder
# ---------------------------------------------------------------------------

class DecoderAttention(nn.Module):
    """Attention with q, k, v projected to dim / downsample (upstream
    `transformer.Attention`)."""

    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

    def forward(self, q, k, v):
        q, k, v = self._heads(self.q_proj(q)), self._heads(self.k_proj(k)), \
            self._heads(self.v_proj(v))
        attn = (q @ k.transpose(-2, -1)) / math.sqrt(q.shape[-1])
        out = attn.softmax(dim=-1) @ v
        b, h, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * c))


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: SamConfig, skip_first_layer_pe: bool):
        super().__init__()
        dim, heads, down = cfg.prompt_width, cfg.decoder_heads, cfg.attention_downsample_rate
        eps = cfg.decoder_norm_eps
        self.self_attn = DecoderAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.cross_attn_token_to_image = DecoderAttention(dim, heads, down)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = MLPBlock(dim, cfg.decoder_mlp_dim, nn.ReLU)
        self.norm3 = nn.LayerNorm(dim, eps=eps)
        self.norm4 = nn.LayerNorm(dim, eps=eps)
        self.cross_attn_image_to_token = DecoderAttention(dim, heads, down)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayBlock(cfg, i == 0)
                                    for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(
            cfg.prompt_width, cfg.decoder_heads, cfg.attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(cfg.prompt_width)

    def forward(self, image, image_pe, tokens):
        keys = image.flatten(2).permute(0, 2, 1)
        key_pe = image_pe.flatten(2).permute(0, 2, 1)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    def __init__(self, dim_in: int, hidden: int, dim_out: int, depth: int):
        super().__init__()
        dims = [dim_in] + [hidden] * (depth - 1) + [dim_out]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig):
        super().__init__()
        dim = cfg.prompt_width
        self.num_mask_tokens = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, dim)
        self.transformer = TwoWayTransformer(cfg)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(dim, dim // 4, kernel_size=2, stride=2), LayerNorm2d(dim // 4),
            nn.GELU(), nn.ConvTranspose2d(dim // 4, dim // 8, kernel_size=2, stride=2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(dim, dim, dim // 8, 3) for _ in range(self.num_mask_tokens))
        self.iou_prediction_head = MLP(dim, cfg.iou_head_hidden_dim, self.num_mask_tokens,
                                       cfg.iou_head_depth)

    def forward(self, image, image_pe, sparse, dense):
        """image [1, C, g, g], image_pe [1, C, g, g], sparse [B, T, C], dense [B, C, g,
        g] -> (multimask logits [B, 3, 4g, 4g], IoU predictions [B, 3])."""
        b = sparse.shape[0]
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], dim=1)
        src = torch.repeat_interleave(image, b, dim=0) + dense
        pos = torch.repeat_interleave(image_pe, b, dim=0)
        _, c, h, w = src.shape
        hs, src = self.transformer(src, pos, tokens)
        iou_out, mask_out = hs[:, 0], hs[:, 1:1 + self.num_mask_tokens]
        up = self.output_upscaling(src.transpose(1, 2).reshape(b, c, h, w))
        hyper = torch.stack([mlp(mask_out[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        _, c, h, w = up.shape
        masks = (hyper @ up.view(b, c, h * w)).view(b, -1, h, w)
        iou = self.iou_prediction_head(iou_out)
        return masks[:, 1:], iou[:, 1:]


# ---------------------------------------------------------------------------
# The model, its pre- and post-processing, and its weights
# ---------------------------------------------------------------------------

def preprocess_shape(h: int, w: int, longest: int) -> tuple[int, int]:
    """(h, w) with the longer side scaled to `longest`, rounded half up."""
    scale = longest * 1.0 / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


def _pil_taps(n_in: int, n_out: int, device):
    """PIL's bilinear taps from `n_in` to `n_out` pixels (Resample.c
    `precompute_coeffs` and `normalize_coeffs_8bpc`), worked out in float64 on `device`:
    (first source index [n_out], fixed-point weights [n_out, K] int64)."""
    f64 = dict(dtype=torch.float64, device=device)
    scale = n_in / n_out
    support = max(scale, 1.0)             # the filter's support scales when shrinking
    k = int(math.ceil(support)) * 2 + 1
    centre = (torch.arange(n_out, **f64) + 0.5) * scale
    xmin = torch.clamp(torch.trunc(centre - support + 0.5), min=0)
    xmax = torch.clamp(torch.trunc(centre + support + 0.5), max=n_in) - xmin
    x = torch.arange(k, **f64)[None, :]
    w = torch.clamp(1.0 - torch.abs((x + xmin[:, None] - centre[:, None] + 0.5)
                                    * (1.0 / support)), min=0.0)
    w = torch.where(x < xmax[:, None], w, 0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total != 0, w / torch.where(total != 0, total, 1.0), w)
    fixed = torch.trunc(w * (1 << PIL_PRECISION_BITS) + torch.where(w < 0, -0.5, 0.5))
    return xmin.long(), fixed.long()


def _pil_pass(img: torch.Tensor, n_out: int, axis: int) -> torch.Tensor:
    """One of PIL's two passes along `axis` (0 rows, 1 columns) of [H, W, C] uint8."""
    n_in = img.shape[axis]
    start, weights = _pil_taps(n_in, n_out, img.device)
    k = weights.shape[1]
    idx = torch.clamp(start[:, None] + torch.arange(k, device=img.device), max=n_in - 1)
    src = img.long().index_select(axis, idx.reshape(-1))
    if axis == 0:
        src = src.view(n_out, k, *img.shape[1:])
        acc = (src * weights[:, :, None, None]).sum(dim=1)
    else:
        src = src.view(img.shape[0], n_out, k, img.shape[2])
        acc = (src * weights[None, :, :, None]).sum(dim=2)
    acc = acc + (1 << (PIL_PRECISION_BITS - 1))
    return torch.clamp(acc >> PIL_PRECISION_BITS, 0, 255).to(torch.uint8)


def resize_bilinear_uint8(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`PIL.Image.resize((width, height), BILINEAR)` of an [H, W, C] uint8 tensor, bit
    for bit, on its device: the horizontal pass, then the vertical one."""
    if img.shape[:2] == (height, width):
        return img
    return _pil_pass(_pil_pass(img, width, 1), height, 0)


class Sam(nn.Module):
    def __init__(self, cfg: SamConfig = SamConfig()):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def preprocess(self, image: torch.Tensor):
        """[h, w, 3] uint8 -> ([1, 3, S, S] normalised and zero-padded, the resized
        (h, w))."""
        cfg = self.cfg
        size = preprocess_shape(*image.shape[:2], cfg.image_size)
        x = resize_bilinear_uint8(image, *size).permute(2, 0, 1).double() * (1 / 255)
        mean, std = tracing.upload("sam.normalise", [PIXEL_MEAN, PIXEL_STD],
                                   device=image.device)[:, :, None, None]
        x = (x.float() - mean) / std
        x = F.pad(x, (0, cfg.image_size - size[1], 0, cfg.image_size - size[0]))
        return x[None], size

    @torch.no_grad()
    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        with exact_float32():
            return self.image_encoder(pixels)

    @torch.no_grad()
    def decode(self, embedding: torch.Tensor, points: torch.Tensor):
        """embedding [1, C, g, g], points [B, 2] in the input frame (one foreground
        point a prompt) -> (low-res logits [B, 3, 4g, 4g], IoU predictions [B, 3])."""
        with exact_float32():
            labels = torch.ones(points.shape[0], 1, dtype=torch.int64, device=points.device)
            sparse, dense = self.prompt_encoder(points[:, None], labels)
            image_pe = self.prompt_encoder.pe_layer.grid(self.cfg.grid)[None]
            return self.mask_decoder(embedding, image_pe, sparse, dense)

    def postprocess(self, low_res: torch.Tensor, input_size, original_size) -> torch.Tensor:
        """Low-res logits -> logits at `original_size`: bilinear to S^2, cropped to the
        resized input, bilinear to the original size."""
        s = self.cfg.image_size
        x = F.interpolate(low_res, (s, s), mode="bilinear", align_corners=False)
        x = x[..., :input_size[0], :input_size[1]]
        return F.interpolate(x, tuple(original_size), mode="bilinear", align_corners=False)


def _seed_of(seed: int, name: str) -> int:
    """The generator seed of one named tensor: the run's seed and the name, hashed."""
    h = seed % (1 << 61)
    for ch in name:
        h = (h * 1_000_003 + ord(ch)) % ((1 << 61) - 1)
    return h


def seeded_state(shapes: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Seeded random weights of every named tensor of `shapes` (a state dict, on the
    meta device or any other), each drawn from its own generator (seeded by `seed` and
    its name) as a normal draw: 1 + 0.1 N for a 1-D weight (LayerNorm scales), 0.02 N for
    any other 1-D tensor (biases), N for the Fourier matrix, 0.1 N for an absolute
    position embedding (a name ending in `pos_embed`), and N / sqrt(fan-in) (the product
    of the trailing sizes) for the rest, the relative-position tables among them."""
    device = torch.device(device)
    out = {}
    for name, t in shapes.items():
        gen = torch.Generator(device=device)
        gen.manual_seed(_seed_of(seed, name))
        x = torch.randn(t.shape, generator=gen, device=device, dtype=torch.float32)
        if t.dim() == 1:
            x = 1.0 + 0.1 * x if name.endswith("weight") else 0.02 * x
        elif name.endswith("positional_encoding_gaussian_matrix"):
            pass
        elif name.endswith("pos_embed"):
            x = 0.1 * x
        else:
            x = x / math.sqrt(math.prod(t.shape[1:]))
        out[name] = x
    return out


def random_state(cfg: SamConfig, seed: int, device) -> dict[str, torch.Tensor]:
    """`seeded_state` of every tensor of `Sam(cfg)`."""
    with torch.device("meta"):
        shapes = Sam(cfg).state_dict()
    return seeded_state(shapes, seed, device)


def build_sam(cfg: SamConfig = SamConfig(), seed: int | None = None, state=None,
              device="cpu") -> Sam:
    """`Sam(cfg)` on `device`, in eval mode, holding `state` or `random_state(cfg,
    seed, device)`."""
    if state is None:
        state = random_state(cfg, seed, device)
    with torch.device("meta"):
        model = Sam(cfg)
    model.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True,
                          assign=True)
    return model.eval()


# `transformers`' SamModel key -> this module's key: substrings replaced in order
_HF_RENAMES = (
    ("vision_encoder.", "image_encoder."),
    ("image_encoder.patch_embed.projection.", "image_encoder.patch_embed.proj."),
    ("image_encoder.layers.", "image_encoder.blocks."),
    (".layer_norm1.", ".norm1."), (".layer_norm2.", ".norm2."),
    (".layer_norm3.", ".norm3."), (".layer_norm4.", ".norm4."),
    ("image_encoder.neck.conv1.", "image_encoder.neck.0."),
    ("image_encoder.neck.norm1.", "image_encoder.neck.1."),
    ("image_encoder.neck.conv2.", "image_encoder.neck.2."),
    ("image_encoder.neck.norm2.", "image_encoder.neck.3."),
    ("prompt_encoder.point_embed.", "prompt_encoder.point_embeddings."),
    ("mask_decoder.transformer.layer_norm_final_attn.",
     "mask_decoder.transformer.norm_final_attn."),
    ("mask_decoder.upscale_conv1.", "mask_decoder.output_upscaling.0."),
    ("mask_decoder.upscale_layer_norm.", "mask_decoder.output_upscaling.1."),
    ("mask_decoder.upscale_conv2.", "mask_decoder.output_upscaling.3."),
)
_HF_MLP = re.compile(r"mask_decoder\.(output_hypernetworks_mlps\.\d+|iou_prediction_head)"
                     r"\.(proj_in|proj_out|layers\.(\d+))\.(weight|bias)$")


def hf_key(key: str, iou_head_depth: int = 3) -> str | None:
    """This module's name of a `transformers` SamModel tensor, or None for one it does
    not hold (the mask prompt's `mask_embed`). The Fourier matrix and its tied copy in
    the prompt encoder both map to the one buffer. An MLP's `proj_in`, `layers.i`, `proj_out` become `layers.0`,
    `layers.<i + 1>`, `layers.<depth - 1>`."""
    if key in ("shared_image_embedding.positional_embedding",
               "prompt_encoder.shared_embedding.positional_embedding"):
        return "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"
    if ".mask_embed." in key:
        return None
    m = _HF_MLP.match(key)
    if m:
        mlp, layer, inner, kind = m.groups()
        depth = iou_head_depth if mlp == "iou_prediction_head" else 3
        i = 0 if layer == "proj_in" else depth - 1 if layer == "proj_out" else int(inner) + 1
        return f"mask_decoder.{mlp}.layers.{i}.{kind}"
    for old, new in _HF_RENAMES:
        key = key.replace(old, new)
    return key


def load_sam(path: str, device="cpu") -> Sam:
    """SAM from a `facebook/sam-vit-huge`-layout directory: `config.json` and
    `model.safetensors` (or `pytorch_model.bin`)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = SamConfig.from_hf(json.load(f))
    weights = os.path.join(path, "model.safetensors")
    if os.path.exists(weights):
        from safetensors.torch import load_file
        raw = load_file(weights)
    else:
        raw = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu",
                         weights_only=True)
    state = {}
    for k, v in raw.items():
        name = hf_key(k, cfg.iou_head_depth)
        if name is not None:
            state[name] = v.to(torch.float32)
    return build_sam(cfg, state=state, device=device)
