"""SAM and CLIP backends of the preprocessing, PyTorch counterpart of
`langsplat_tpu/preprocess/backends.py`. `SamPredictor` runs the port's own SAM
(`models/sam.py`) and `ClipImageEncoder` the port's own CLIP image tower
(`models/clip.py`), each built from a seed or loaded from a local `transformers`-layout
checkpoint directory (`facebook/sam-vit-huge`, `laion/CLIP-ViT-B-16-laion2B-s34b-b88k`).
`TransformersSamPredictor` and `TransformersClipImageEncoder` load through
`transformers`; the tests hold the port's models against them. All run on the CUDA card
unless `device` says otherwise, and their outputs stay tensors on that device.

Any other pair of callables works: the pipeline needs `predictor(image, points) ->
(masks, iou_preds, logits)` and `encode(tiles) -> embeddings`. A predictor that also
has `set_image`, `decode` and `upscale` (as `SamPredictor` has) lets the mask generator
encode each crop once.
"""

from __future__ import annotations

import numpy as np
import torch

from langsplat_tpu_torch.device import resolve_device
from langsplat_tpu_torch.models import clip as clip_model
from langsplat_tpu_torch.models import sam as sam_model
from langsplat_tpu_torch.utils import tracing

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class SamPredictor:
    """SAM's predictor over the port's model: `set_image(crop)` encodes a crop once and
    keeps its [C, 64, 64] embedding; `decode(points)` prompts it with one foreground
    point each, giving the low-res logits [P, 3, 256, 256] and IoU predictions [P, 3];
    `upscale` takes the logits to the crop's size. `predictor(crop, points)` does all
    three, as `TransformersSamPredictor` does, and returns (masks [P, 3, h, w] bool,
    iou_preds [P, 3], logits [P, 3, h, w]).

    `model` is a `models.sam.Sam` or a checkpoint directory (`models.sam.load_sam`)."""

    def __init__(self, model, device=None):
        self.device = resolve_device(device)
        if isinstance(model, str):
            model = sam_model.load_sam(model, device=self.device)
        self.model = model
        self.embedding = None
        self.crop_size = self.input_size = None

    def set_image(self, crop: np.ndarray) -> None:
        image = tracing.upload("sam.image", np.ascontiguousarray(crop), device=self.device)
        pixels, self.input_size = self.model.preprocess(image)
        self.crop_size = tuple(crop.shape[:2])
        self.embedding = self.model.embed(pixels)
        tracing.COUNTERS["sam.encoder_passes"] += 1

    def decode(self, points: np.ndarray):
        """points [P, 2] xy pixels of the crop -> (low-res logits, IoU predictions)."""
        h, w = self.crop_size
        scale = np.array([self.input_size[1] / w, self.input_size[0] / h])
        coords = tracing.upload("sam.points", np.asarray(points, np.float64) * scale,
                                dtype=torch.float32, device=self.device)
        tracing.COUNTERS["sam.decoder_batches"] += 1
        tracing.COUNTERS["sam.prompts"] += len(coords)
        return self.model.decode(self.embedding, coords)

    def upscale(self, low_res: torch.Tensor) -> torch.Tensor:
        return self.model.postprocess(low_res, self.input_size, self.crop_size)

    def __call__(self, crop: np.ndarray, points: np.ndarray):
        self.set_image(crop)
        low_res, iou = self.decode(points)
        logits = self.upscale(low_res)
        return logits > sam_model.MASK_THRESHOLD, iou, logits


class TransformersSamPredictor:
    """predictor(image [H, W, 3] uint8, points [P, 2] xy pixels) -> (masks [P, 3, H, W]
    bool, iou_preds [P, 3], logits [P, 3, H, W]) on the device: SAM's three multimask
    heads, the logits resized to the image by the processor's `post_process_masks`.
    Each call runs SAM's image encoder again, as the JAX package does. The tests hold
    `SamPredictor` against it."""

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


class ClipImageEncoder:
    """encode(tiles [M, 3, 224, 224] float in [0, 1]) -> [M, 512] image embeddings on
    the device through the port's CLIP image tower, `batch_size` tiles a forward pass
    (the span `clip_encoder` each; counters `clip.tiles`, `clip.encoder_batches`).

    `model` is a `models.clip.ClipVision` or a checkpoint directory
    (`models.clip.load_clip`)."""

    def __init__(self, model, device=None, batch_size: int = 64):
        self.device = resolve_device(device)
        if isinstance(model, str):
            model = clip_model.load_clip(model, device=self.device)
        self.model = model
        self.batch_size = batch_size
        self.mean, self.std = tracing.upload("clip.normalise", [CLIP_MEAN, CLIP_STD],
                                             device=self.device)[:, None, :, None, None]

    def __call__(self, tiles) -> torch.Tensor:
        tiles = torch.as_tensor(tiles, dtype=torch.float32, device=self.device)
        out = []
        for i in range(0, len(tiles), self.batch_size):
            with tracing.span("clip_encoder"):
                out.append(self.model.embed((tiles[i:i + self.batch_size] - self.mean)
                                            / self.std))
            tracing.COUNTERS["clip.encoder_batches"] += 1
        tracing.COUNTERS["clip.tiles"] += len(tiles)
        return torch.cat(out)


class TransformersClipImageEncoder:
    """encode(tiles [M, 3, 224, 224] float in [0, 1]) -> [M, 512] image embeddings on
    the device, `batch_size` tiles per forward pass, through `transformers`' CLIPModel.
    The tests hold `ClipImageEncoder` against it."""

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
