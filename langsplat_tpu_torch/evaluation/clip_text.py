"""Text embeddings of the eval prompts for the PyTorch port.

Only the offline encoder, `PrecomputedTextEncoder` (an npz of {prompt: [D]}), is here.
The JAX package's `ClipTextEncoder` needs `transformers` and local CLIP weights that the
repository does not hold; it waits with the preprocessing (ROADMAP item 7).
"""

from __future__ import annotations

import numpy as np


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
