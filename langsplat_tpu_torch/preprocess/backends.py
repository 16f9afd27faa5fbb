"""SAM and CLIP backends of the preprocessing, PyTorch counterpart of
`langsplat_tpu/preprocess/backends.py`: both load through `transformers` from a local
checkpoint directory (`facebook/sam-vit-huge`- and
`laion/CLIP-ViT-B-16-laion2B-s34b-b88k`-compatible) and run on the CUDA card unless
`device` says otherwise. Their outputs stay tensors on that device.

Any other pair of callables works: the pipeline needs `predictor(image, points) ->
(masks, iou_preds, logits)` and `encode(tiles) -> embeddings`.
"""

from __future__ import annotations

import numpy as np
import torch

from langsplat_tpu_torch.device import resolve_device

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class TransformersSamPredictor:
    """predictor(image [H, W, 3] uint8, points [P, 2] xy pixels) -> (masks [P, 3, H, W]
    bool, iou_preds [P, 3], logits [P, 3, H, W]) on the device: SAM's three multimask
    heads, the logits resized to the image by the processor's `post_process_masks`.
    Each call runs SAM's image encoder again, as the JAX package does."""

    def __init__(self, model_name_or_path: str = "facebook/sam-vit-huge", device=None):
        self.device = resolve_device(device)
        try:
            from transformers import SamModel, SamProcessor
        except ImportError as e:
            raise RuntimeError("transformers unavailable") from e
        self.model = SamModel.from_pretrained(model_name_or_path).to(self.device).eval()
        self.processor = SamProcessor.from_pretrained(model_name_or_path)

    def __call__(self, image: np.ndarray, points: np.ndarray):
        input_points = [[[list(map(float, p))] for p in points]]
        inputs = self.processor(image, input_points=input_points,
                                return_tensors="pt").to(self.device)
        with torch.no_grad():
            out = self.model(**inputs, multimask_output=True)
        logits = self.processor.image_processor.post_process_masks(
            out.pred_masks, inputs["original_sizes"], inputs["reshaped_input_sizes"],
            binarize=False)[0]                        # [P, 3, H, W]
        return logits > 0.0, out.iou_scores[0], logits


class TransformersClipImageEncoder:
    """encode(tiles [M, 3, 224, 224] float in [0, 1]) -> [M, 512] image embeddings on
    the device, `batch_size` tiles per forward pass."""

    def __init__(self,
                 model_name_or_path: str = "laion/CLIP-ViT-B-16-laion2B-s34b-b88k",
                 device=None, batch_size: int = 64):
        self.device = resolve_device(device)
        try:
            from transformers import CLIPModel
        except ImportError as e:
            raise RuntimeError("transformers unavailable") from e
        self.model = CLIPModel.from_pretrained(model_name_or_path).to(self.device).eval()
        self.batch_size = batch_size
        self.mean = torch.tensor(CLIP_MEAN, device=self.device)[None, :, None, None]
        self.std = torch.tensor(CLIP_STD, device=self.device)[None, :, None, None]

    def __call__(self, tiles) -> torch.Tensor:
        tiles = torch.as_tensor(tiles, dtype=torch.float32, device=self.device)
        normed = (tiles - self.mean) / self.std
        with torch.no_grad():
            return torch.cat([image_features(self.model, normed[i:i + self.batch_size])
                              for i in range(0, len(normed), self.batch_size)])


def image_features(model, pixel_values: torch.Tensor) -> torch.Tensor:
    """CLIPModel.get_image_features written out (the vision tower's pooled output
    through the visual projection), so that the result is a tensor in every
    `transformers` version."""
    return model.visual_projection(model.vision_model(pixel_values=pixel_values).pooler_output)
