"""Text embeddings of the eval prompts for the PyTorch port.

`ClipTextEncoder` is the JAX package's CLIP text encoder: `transformers`' CLIPModel and
CLIPTokenizer loaded from a local checkpoint directory (`DEFAULT_MODEL`-compatible;
the reference's open_clip ViT-B-16 laion2b_s34b_b88k), on the CUDA card unless
`device` says otherwise. `PrecomputedTextEncoder` serves an npz of {prompt: [D]}
instead, for runs without CLIP weights.
"""

from __future__ import annotations

import numpy as np

DEFAULT_MODEL = "laion/CLIP-ViT-B-16-laion2B-s34b-b88k"


class ClipTextEncoder:
    """encode(list[str]) -> [K, 512] float32 L2-normalized embeddings (numpy)."""

    def __init__(self, model_name_or_path: str = DEFAULT_MODEL, device=None):
        from langsplat_tpu_torch.device import resolve_device
        self.device = resolve_device(device)
        try:
            from transformers import CLIPModel, CLIPTokenizer
        except ImportError as e:
            raise RuntimeError("transformers unavailable; use "
                               "PrecomputedTextEncoder instead") from e
        self.model = CLIPModel.from_pretrained(model_name_or_path).to(self.device).eval()
        self.tokenizer = CLIPTokenizer.from_pretrained(model_name_or_path)

    def __call__(self, prompts: list[str]) -> np.ndarray:
        import torch
        with torch.no_grad():
            tokens = self.tokenizer(prompts, padding=True,
                                    return_tensors="pt").to(self.device)
            # CLIPModel.get_text_features written out (the text tower's pooled output
            # through the text projection): a tensor in every transformers version
            feats = self.model.text_projection(self.model.text_model(**tokens).pooler_output)
            feats = feats / feats.norm(dim=-1, keepdim=True)
        return feats.cpu().numpy().astype(np.float32)


class PrecomputedTextEncoder:
    """Offline text "encoder" backed by an npz of {prompt: [D]} embeddings; returns
    [K, D] float32 rows divided by (norm + 1e-12)."""

    def __init__(self, npz_path: str | None = None, table: dict | None = None):
        if table is None:
            with np.load(npz_path) as data:
                table = {k: data[k] for k in data.files}
        self.table = {k: np.asarray(v, np.float32) for k, v in table.items()}

    def __call__(self, prompts: list[str]) -> np.ndarray:
        missing = [p for p in prompts if p not in self.table]
        if missing:
            raise KeyError(f"no precomputed embeddings for {missing}")
        out = np.stack([self.table[p] for p in prompts])
        return out / (np.linalg.norm(out, axis=-1, keepdims=True) + 1e-12)
