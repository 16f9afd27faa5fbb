"""Preprocessing, closed loop with one client: `AutoMaskGenerator.generate` of one view
after another (SAM's automatic masks at four granularities with the preprocessing CLI's
settings: 32 x 32 points, one crop layer, so 5 crops and 5 encoder passes, 64 points a
batch, so 80 decoder batches), each call timed from the call to a synchronize, cycling
over the views in an order drawn from the seed. Set-up builds SAM at the
configuration's widths with weights from the seed, makes the views and generates
`warm_views` views not among the checked ones.

The comparison takes, for `checked_views` positions of the order drawn from the seed,
the first `generate` of that view in the window and, of each of its crops, the image
embedding the predictor kept, and for one batch a crop (drawn from the seed) the
low-res logits, the IoU predictions and the logits at the crop's size; the reference
works each out again from the seed (`reference/sam.py`).
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from bench_port import harness, trace
from bench_port.drivers import program
from bench_port.reference import FLOAT32, Precision
from bench_port.reference import sam as ref_sam
from langsplat_tpu_torch.models.sam import SamConfig, build_sam
from langsplat_tpu_torch.preprocess.auto_mask import AutoMaskConfig, AutoMaskGenerator
from langsplat_tpu_torch.preprocess.backends import SamPredictor

GENERATOR_KEYS = ("points_per_side", "points_per_batch", "pred_iou_thresh",
                  "stability_score_thresh", "box_nms_thresh", "crop_n_layers",
                  "min_mask_region_area")


def sam_config(cfg: dict) -> SamConfig:
    """The program's SamConfig of a configuration file."""
    return SamConfig(
        image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        encoder_width=cfg["encoder_embed_dim"], encoder_depth=cfg["encoder_depth"],
        encoder_heads=cfg["encoder_num_heads"],
        encoder_mlp_dim=int(cfg["encoder_embed_dim"] * cfg["mlp_ratio"]),
        window_size=cfg["window_size"],
        global_attn_indexes=tuple(cfg["encoder_global_attn_indexes"]),
        prompt_width=cfg["prompt_embed_dim"], decoder_depth=cfg["decoder_depth"],
        decoder_heads=cfg["decoder_num_heads"], decoder_mlp_dim=cfg["decoder_mlp_dim"],
        attention_downsample_rate=cfg["attention_downsample_rate"],
        num_multimask_outputs=cfg["num_multimask_outputs"],
        iou_head_depth=cfg["iou_head_depth"], iou_head_hidden_dim=cfg["iou_head_hidden_dim"])


def views_of(cfg: dict, seed: int, device) -> list[np.ndarray]:
    """The cell's views, [H, W, 3] uint8 on the host, from `harness.gt_images`."""
    images = harness.gt_images(seed, cfg["views"], cfg["height"], cfg["width"], device)
    u8 = torch.clamp(torch.round(images * 255), 0, 255).to(torch.uint8)
    return list(u8.permute(0, 2, 3, 1).contiguous().cpu().numpy())


class Capture:
    """Wraps the predictor's `set_image`, `decode` and `upscale` (instance attributes,
    which the generator calls) to keep, while `on`, each crop's embedding and one
    batch's outputs: `crops` is a list, one dict a crop."""

    def __init__(self, predictor, batch_of):
        self.on, self.crops, self.batch_of = False, [], batch_of
        set_image, decode, upscale = predictor.set_image, predictor.decode, predictor.upscale
        self._batch = 0

        def set_image_(crop):
            set_image(crop)
            if self.on:
                self.crops.append(dict(embedding=predictor.embedding[0]))
                self._batch = 0

        def decode_(points):
            low_res, iou = decode(points)
            if self.on:
                crop = self.crops[-1]
                if self._batch == self.batch_of(len(self.crops) - 1):
                    crop.update(batch=self._batch, low_res=low_res, iou=iou)
                self._batch += 1
            return low_res, iou

        def upscale_(low_res):
            logits = upscale(low_res)
            if self.on and self.crops[-1].get("low_res") is low_res:
                self.crops[-1]["logits"] = logits
            return logits

        predictor.set_image, predictor.decode, predictor.upscale = \
            set_image_, decode_, upscale_

    def start(self) -> None:
        self.on, self.crops = True, []

    def stop(self) -> list:
        self.on = False
        return self.crops


class Run:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, mix = cell.config, cell.mix
        self.sizes = ref_sam.sizes(cfg)
        self.views = views_of(cfg, seed, device)
        self.n_views = len(self.views)
        rng = random.Random(seed)
        self.order = list(range(self.n_views))
        rng.shuffle(self.order)
        positions = rng.sample(range(min(self.n_views, mix["traced_views"])),
                               mix["checked_views"])
        self.checked = {self.order[p] for p in positions}
        boxes = ref_sam.crop_boxes(cfg["height"], cfg["width"], cfg["crop_n_layers"],
                                   AutoMaskConfig().crop_overlap_ratio)
        batches = -(-cfg["points_per_side"] ** 2 // cfg["points_per_batch"])
        self.batch = {(v, c): rng.randrange(batches) for v in sorted(self.checked)
                      for c in range(len(boxes))}
        self.crops, self.batches_per_crop = len(boxes), batches
        self.model = build_sam(sam_config(cfg), seed=seed, device=device)
        self.predictor = SamPredictor(self.model, device=device)
        self.generator = AutoMaskGenerator(
            self.predictor, AutoMaskConfig(**{k: cfg[k] for k in GENERATOR_KEYS}),
            device=device)
        self._view = None
        self.capture = Capture(self.predictor, lambda c: self.batch[(self._view, c)])
        self.program: dict[int, list] = {}     # view -> its crops' captured outputs
        for i in range(mix["warm_views"]):
            self.generator.generate(self.views[self.order[-1 - i]])
        program.synchronize(device)

    def _call(self, i: int) -> float:
        v = self.order[i % self.n_views]
        capture = v in self.checked and v not in self.program
        if capture:
            self._view = v
            self.capture.start()
        t0 = time.perf_counter()
        self.generator.generate(self.views[v])
        program.synchronize(self.device)
        latency = time.perf_counter() - t0
        if capture:
            self.program[v] = self.capture.stop()
        return latency

    def window(self, seconds: float) -> dict:
        latencies, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds or not latencies:
            latencies.append(self._call(len(latencies)))
        elapsed = time.perf_counter() - t0
        harness.log_calls("generate", latencies)
        return dict(metrics={"render_views_per_s": len(latencies) / elapsed},
                    attempted=len(latencies), failed=len(self.checked - set(self.program)))

    def traced(self) -> dict:
        """The first `traced_views` calls of the window's order, timed without the
        profiler and then under it, with the predictor's `set_image` in the span
        `bench.sam_encoder`, and its `decode`, `upscale` and the generator's filters in
        `bench.sam_decoder`."""
        calls = self.cell.mix["traced_views"]
        untraced_s = trace.untraced_seconds(self._call, calls, self.device, lambda: None)
        pred, gen = self.predictor, self.generator
        saved = pred.set_image, pred.decode, pred.upscale, gen._filter_batch
        pred.set_image = trace.spanned("sam_encoder", saved[0])
        pred.decode = trace.spanned("sam_decoder", saved[1])
        pred.upscale = trace.spanned("sam_decoder", saved[2])
        gen._filter_batch = trace.spanned("sam_decoder", saved[3])
        try:
            reading = trace.profile(self._call, calls, self.device)
        finally:
            pred.set_image, pred.decode, pred.upscale, gen._filter_batch = saved
        views = [self.order[i % self.n_views] for i in range(calls)]
        return dict(reading=dict(reading, untraced_s=untraced_s), views=views,
                    attempted=calls)

    def work(self, ctx: dict) -> None:
        """Each traced call's crops and prompts (every crop is encoded once and decodes
        all of its points)."""
        cfg = self.cell.config
        prompts = self.crops * cfg["points_per_side"] ** 2
        ctx["work"] = [dict(config=cfg, crops=self.crops, prompts=prompts,
                            batches=self.crops * self.batches_per_crop)
                       for _ in ctx["views"]]
        ctx["kind"] = "preprocess"

    def release(self) -> None:
        self.model = self.predictor = self.generator = self.capture = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, pr: Precision = FLOAT32, tf32: bool = False,
                  global_rel_pos: bool = True) -> dict:
        """The reference's outputs of each checked view's crops, from the weights and
        views it makes again from the seed."""
        ar = ref_sam.Arith(pr, tf32, global_rel_pos)
        cfg, s = self.cell.config, self.sizes
        w = ref_sam.weights(s, self.seed, self.device)
        views = views_of(cfg, self.seed, self.device)
        boxes = ref_sam.crop_boxes(cfg["height"], cfg["width"], cfg["crop_n_layers"],
                                   AutoMaskConfig().crop_overlap_ratio)
        n = cfg["points_per_side"]
        out = {}
        for v in sorted(self.checked):
            crops = []
            for c, (x0, y0, x1, y1) in enumerate(boxes):
                image = torch.as_tensor(views[v][y0:y1, x0:x1], device=self.device)
                emb, in_size = ref_sam.embed(w, s, image, ar)
                size = (y1 - y0, x1 - x0)
                b, per = self.batch[(v, c)], cfg["points_per_batch"]
                points = (ref_sam.point_grid(n) * np.array([size[1], size[0]]))[
                    b * per:(b + 1) * per]
                low, iou = ref_sam.decode(w, s, emb, points, size, in_size, ar)
                crops.append(dict(embedding=emb, batch=b, low_res=low, iou=iou,
                                  logits=ref_sam.upscale(low, s, in_size, size, ar)))
            out[v] = crops
        return out

    @staticmethod
    def compare(run: dict, ref: dict) -> dict:
        """embedding_gap, logit_gap (the low-res and the crop-size logits), iou_gap: the
        largest absolute gap over every checked view's crops, over the reference's
        largest magnitude of the same tensor; a view or crop the run lacks fails."""
        worst = dict(embedding_gap=0.0, logit_gap=0.0, iou_gap=0.0)
        keys = dict(embedding_gap=("embedding",), logit_gap=("low_res", "logits"),
                    iou_gap=("iou",))

        def gap(a, b):
            if a is None or a.shape != b.shape:
                return math.inf
            g = float((a - b).abs().max()) / float(b.abs().max())
            return g if math.isfinite(g) else math.inf

        for v, crops in ref.items():
            got = run.get(v, [])
            for c, r in enumerate(crops):
                p = got[c] if c < len(got) and got[c].get("batch") == r["batch"] else {}
                for name, tensors in keys.items():
                    for t in tensors:
                        worst[name] = max(worst[name], gap(p.get(t), r[t]))
        return worst

    def check(self) -> dict:
        return self.compare(self.program, self.reference())
