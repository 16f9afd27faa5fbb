"""CLIP's image tower in plain PyTorch: OpenCLIP `ViT-B-16`, the model LangSplat's
preprocessing embeds every mask's tile with (`preprocess.py OpenCLIPNetwork`, pretrained
`laion2b_s34b_b88k`).

`ClipVisionConfig()` is ViT-B/16: a 16x16 patch embedding without bias of a 224^2
input to 768 channels (196 tokens), a class token and learned positions [197, 768],
`ln_pre`, 12 pre-norm blocks (x + MHA(LN(x)) with 12 heads of 64, softmax(q k^T / 8) v
with no mask; x + MLP(LN(x)) with a GELU MLP of 3072), then `ln_post` of the class
token and a projection to 512 without bias. LayerNorm epsilon 1e-5. The GELU is the
exact (erf) form, as OpenCLIP builds the laion checkpoints; `act="quick_gelu"` is the
OpenAI weights' x sigmoid(1.702 x), which `transformers`' `CLIPVisionConfig` takes by
default. 86,192,640 parameters.

The MLP is SAM's (`models/sam.py MLPBlock`); each block's q, k and v are one product.
Everything runs in float32 without TF32 (`sam.exact_float32`), as the preprocessing's
CLIP always has: upstream builds the model in fp16, a departure the benchmark's
configuration records.

Weights come from a `transformers` CLIPModel directory (`load_clip`: its `config.json`
and `model.safetensors` or `pytorch_model.bin`, the `vision_model.*` and
`visual_projection.weight` tensors through `hf_key`, q, k and v concatenated), or from a
seed (`build_clip`, by `sam.seeded_state`'s per-tensor rule). Nothing here imports
`transformers`.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass

import torch
from torch import nn

from langsplat_tpu_torch.models import sam


@dataclass(frozen=True)
class ClipVisionConfig:
    """The image tower's sizes; the defaults are OpenCLIP ViT-B/16's."""
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    output_dim: int = 512
    act: str = "gelu"
    layer_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def from_hf(cls, config: dict) -> "ClipVisionConfig":
        """The sizes of a `transformers` CLIPConfig's `config.json`; a key it leaves out
        takes `transformers`' default (patch 32 and QuickGELU among them)."""
        v = config.get("vision_config", {})
        return cls(image_size=v.get("image_size", 224), patch_size=v.get("patch_size", 32),
                   width=v.get("hidden_size", 768), layers=v.get("num_hidden_layers", 12),
                   heads=v.get("num_attention_heads", 12),
                   mlp_dim=v.get("intermediate_size", 3072),
                   output_dim=config.get("projection_dim", 512),
                   act=v.get("hidden_act", "quick_gelu"),
                   layer_norm_eps=v.get("layer_norm_eps", 1e-5))


class QuickGELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"gelu": nn.GELU, "quick_gelu": QuickGELU}


class Attention(nn.Module):
    """Multi-head self-attention over [B, T, D] tokens, no mask."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        q, k, v = self.qkv(x).reshape(b, t, 3, self.heads, -1).permute(2, 0, 3, 1, 4)
        attn = ((q * self.scale) @ k.transpose(-2, -1)).softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, t, d))


class Block(nn.Module):
    """x + attn(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.attn = Attention(cfg.width, cfg.heads)
        self.norm2 = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.mlp = sam.MLPBlock(cfg.width, cfg.mlp_dim, ACTIVATIONS[cfg.act])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ClipVision(nn.Module):
    """[B, 3, S, S] normalised pixels -> [B, output_dim] image embeddings."""

    def __init__(self, cfg: ClipVisionConfig = ClipVisionConfig()):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Conv2d(3, cfg.width, kernel_size=cfg.patch_size,
                                     stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.grid ** 2 + 1, cfg.width))
        self.ln_pre = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.layers))
        self.ln_post = nn.LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.proj = nn.Linear(cfg.width, cfg.output_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(pixels).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.ln_pre(torch.cat([cls, x], dim=1) + self.pos_embed)
        for blk in self.blocks:
            x = blk(x)
        return self.proj(self.ln_post(x[:, 0]))

    @torch.no_grad()
    def embed(self, pixels: torch.Tensor) -> torch.Tensor:
        with sam.exact_float32():
            return self(pixels)


def build_clip(cfg: ClipVisionConfig = ClipVisionConfig(), seed: int | None = None,
               state=None, device="cpu") -> ClipVision:
    """`ClipVision(cfg)` on `device`, in eval mode, holding `state` or the seeded
    weights of `sam.seeded_state`."""
    with torch.device("meta"):
        model = ClipVision(cfg)
    if state is None:
        state = sam.seeded_state(model.state_dict(), seed, device)
    model.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True,
                          assign=True)
    return model.eval()


# `transformers`' CLIPModel key -> this module's key: substrings replaced in order
_HF_RENAMES = (
    ("vision_model.embeddings.patch_embedding.", "patch_embed."),
    ("vision_model.embeddings.class_embedding", "class_embedding"),
    ("vision_model.embeddings.position_embedding.weight", "pos_embed"),
    ("vision_model.pre_layrnorm.", "ln_pre."),
    ("vision_model.post_layernorm.", "ln_post."),
    ("vision_model.encoder.layers.", "blocks."),
    (".layer_norm1.", ".norm1."), (".layer_norm2.", ".norm2."),
    (".self_attn.out_proj.", ".attn.proj."),
    (".mlp.fc1.", ".mlp.lin1."), (".mlp.fc2.", ".mlp.lin2."),
    ("visual_projection.", "proj."),
)
_HF_QKV = re.compile(r"(blocks\.\d+)\.self_attn\.([qkv])_proj\.(weight|bias)$")


def hf_key(key: str) -> str | None:
    """This module's name of a `transformers` CLIPModel tensor, or None for one it does
    not hold (the text tower, the logit scale, position ids). A block's `q_proj`,
    `k_proj` and `v_proj` map to `<block>.self_attn.<q|k|v>_proj.<kind>`, which
    `load_clip` concatenates into `<block>.attn.qkv.<kind>`."""
    if not key.startswith(("vision_model.", "visual_projection.")) \
            or key.endswith("position_ids"):
        return None
    for old, new in _HF_RENAMES:
        key = key.replace(old, new)
    return key


def load_clip(path: str, device="cpu") -> ClipVision:
    """CLIP's image tower from a `transformers` CLIPModel directory (the layout of
    `laion/CLIP-ViT-B-16-laion2B-s34b-b88k`): `config.json` and `model.safetensors` (or
    `pytorch_model.bin`)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = ClipVisionConfig.from_hf(json.load(f))
    weights = os.path.join(path, "model.safetensors")
    if os.path.exists(weights):
        from safetensors.torch import load_file
        raw = load_file(weights)
    else:
        raw = torch.load(os.path.join(path, "pytorch_model.bin"), map_location="cpu",
                         weights_only=True)
    state, qkv = {}, {}
    for k, v in raw.items():
        name = hf_key(k)
        if name is None:
            continue
        m = _HF_QKV.match(name)
        if m:
            qkv.setdefault((m.group(1), m.group(3)), {})[m.group(2)] = v
        else:
            state[name] = v.to(torch.float32)
    for (block, kind), parts in qkv.items():
        state[f"{block}.attn.qkv.{kind}"] = torch.cat(
            [parts["q"], parts["k"], parts["v"]]).to(torch.float32)
    return build_clip(cfg, state=state, device=device)
