"""The mask-to-embedding stage, closed loop with one client: `embed_masks` of one view
after another (`masks_update`, then per level the CLIP tiles and seg map, the image
tower 64 tiles a pass, the L2 norm and the float16 cast), each call timed from the call
to a synchronize, cycling over the views in an order drawn from the seed. Set-up makes
the views and every view's mask records from the seed and holds the records on the
device as `AutoMaskGenerator.generate` hands them on (`view_masks`), builds the image
tower at the configuration's widths with weights from the seed and embeds
`warm_views` views not among the checked ones.

The comparison takes, for `checked_views` positions of the order drawn from the seed,
the first `embed_masks` of that view in the window: per level the indices of the masks
`masks_update` kept, the tiles and the tower's float32 outputs it encoded, the seg map
and the float16 features it returned; the reference works each out again from the seed
(`reference/clip.py`).
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from bench_port import harness, trace
from bench_port.drivers import program
from bench_port.drivers.preprocess import views_of
from bench_port.reference import FLOAT32, Precision
from bench_port.reference import clip as ref_clip
from langsplat_tpu_torch.models.clip import ClipVisionConfig, build_clip
from langsplat_tpu_torch.preprocess import pipeline
from langsplat_tpu_torch.preprocess.backends import ClipImageEncoder

LEVELS = ref_clip.LEVELS
#: the records' aspect ratios (major over minor radius) are log-uniform in this range
ASPECT = (0.4, 2.5)
#: a nested mask's area over its parent's, uniform
NESTED_AREA = (0.05, 0.45)
#: the second ellipse of a union, its area over the first's, uniform
UNION_AREA = (0.3, 1.0)


def clip_config(cfg: dict) -> ClipVisionConfig:
    """The program's ClipVisionConfig of a configuration file."""
    s = ref_clip.sizes(cfg)
    return ClipVisionConfig(image_size=s["image_size"], patch_size=s["patch"],
                            width=s["width"], layers=s["layers"], heads=s["heads"],
                            mlp_dim=s["mlp"], output_dim=s["output"], act=s["act"],
                            layer_norm_eps=s["eps"])


# ---------------------------------------------------------------------------
# The masks
# ---------------------------------------------------------------------------

def _ellipse(rng, area: float, cx: float, cy: float) -> list[float]:
    aspect = math.exp(rng.uniform(math.log(ASPECT[0]), math.log(ASPECT[1])))
    return [cx, cy, math.sqrt(area * aspect / math.pi), math.sqrt(area / (aspect * math.pi)),
            rng.uniform(0.0, math.pi)]


def _radius2(e, x: float, y: float) -> float:
    """(x, y)'s squared normalised distance from the centre of ellipse e."""
    cx, cy, a, b, t = e
    dx, dy = x - cx, y - cy
    u = (dx * math.cos(t) + dy * math.sin(t)) / a
    v = (-dx * math.sin(t) + dy * math.cos(t)) / b
    return u * u + v * v


def _inside(rng, e, width: int, height: int) -> tuple[float, float]:
    """A pixel centre well inside ellipse e: drawn within half its radii, else its own
    centre."""
    cx, cy, a, b, t = e
    u, v = rng.uniform(-0.5, 0.5, 2) * (a, b)
    x = min(max(math.floor(cx + u * math.cos(t) - v * math.sin(t)), 0), width - 1) + 0.5
    y = min(max(math.floor(cy + u * math.sin(t) + v * math.cos(t)), 0), height - 1) + 0.5
    return (x, y) if _radius2(e, x, y) <= 0.8 else (cx, cy)


def _level_shapes(rng, cfg: dict, lo: int, hi: int) -> list[dict]:
    """One level's masks, each {"ellipses": [[cx, cy, a, b, theta], ...] (a union),
    "parent": index or None (nested: the ellipse cut to the parent's mask)}, in a
    shuffled order."""
    width, height = cfg["width"], cfg["height"]
    least = cfg["mask_min_area"]
    most = cfg["mask_max_area_share"] * width * height
    n = int(rng.integers(lo, hi + 1))
    n_nested = int(round(n * cfg["nested_share"]))
    shapes = []
    for _ in range(n - n_nested):
        area = math.exp(rng.uniform(math.log(least), math.log(most)))
        e = _ellipse(rng, area, rng.integers(width) + 0.5, rng.integers(height) + 0.5)
        ellipses = [e]
        if rng.random() < cfg["union_share"]:
            ellipses.append(_ellipse(rng, area * rng.uniform(*UNION_AREA),
                                     *_inside(rng, e, width, height)))
        shapes.append(dict(ellipses=ellipses, parent=None, area=area))
    parents = [k for k, s in enumerate(shapes)
               if s["area"] >= 2 * least and min(s["ellipses"][0][2:4]) >= 4.0]
    for _ in range(n_nested if parents else 0):
        k = parents[int(rng.integers(len(parents)))]
        e = shapes[k]["ellipses"][0]
        area = max(least, shapes[k]["area"] * rng.uniform(*NESTED_AREA))
        shapes.append(dict(ellipses=[_ellipse(rng, area, *_inside(rng, e, width, height))],
                           parent=k, area=area))
    perm = [int(i) for i in rng.permutation(len(shapes))]
    where = {old: new for new, old in enumerate(perm)}
    return [dict(shapes[old], parent=None if shapes[old]["parent"] is None
                 else where[shapes[old]["parent"]]) for old in perm]


def _raster(ellipses: list, height: int, width: int, device) -> torch.Tensor:
    """[E, H, W] bool: the pixel centres inside each ellipse."""
    f32 = dict(dtype=torch.float32, device=device)
    p = torch.tensor(ellipses, **f32)
    xs = (torch.arange(width, **f32) + 0.5)[None, None, :]
    ys = (torch.arange(height, **f32) + 0.5)[None, :, None]
    out = []
    for i in range(0, len(p), 32):
        cx, cy, a, b, t = (c[:, None, None] for c in p[i:i + 32].T)
        dx, dy = xs - cx, ys - cy
        u = (dx * torch.cos(t) + dy * torch.sin(t)) / a
        v = (dy * torch.cos(t) - dx * torch.sin(t)) / b
        out.append(u * u + v * v <= 1.0)
    return torch.cat(out)


def _bbox(masks: torch.Tensor) -> np.ndarray:
    """[M, 4] float64 XYWH boxes of [M, H, W] bool masks, none empty."""
    def extent(hit):
        n = hit.shape[1]
        first = hit.to(torch.uint8).argmax(dim=1)
        last = n - 1 - hit.flip(1).to(torch.uint8).argmax(dim=1)
        return first, last - first + 1
    x0, w = extent(masks.any(dim=1))
    y0, h = extent(masks.any(dim=2))
    return torch.stack([x0, y0, w, h], dim=1).double().cpu().numpy()


def view_masks(cfg: dict, seed: int, view: int, device) -> list[list[dict]]:
    """The four levels of one view's mask records, made from the seed, with the keys of
    `AutoMaskGenerator.generate`'s records that `embed_masks` reads: `segmentation`
    [H, W] bool on the device (rows of one tensor a level), `bbox` XYWH float64,
    `predicted_iou`, `stability_score`. Every mask holds its first ellipse's centre
    pixel, so none is empty."""
    rng = np.random.default_rng([seed % 2 ** 64, view])
    height, width = cfg["height"], cfg["width"]
    levels = []
    for level in LEVELS:
        shapes = _level_shapes(rng, cfg, *cfg["masks_per_level"][level])
        flat = [e for s in shapes for e in s["ellipses"]]
        inside = _raster(flat, height, width, device)
        masks, i = [], 0
        for s in shapes:
            n = len(s["ellipses"])
            masks.append(inside[i:i + n].any(dim=0))
            i += n
        for k, s in enumerate(shapes):
            if s["parent"] is not None:
                masks[k] = masks[k] & masks[s["parent"]]
        masks = torch.stack(masks)
        del inside
        boxes = _bbox(masks)
        iou = rng.uniform(*cfg["predicted_iou"], len(shapes))
        stab = rng.uniform(*cfg["stability_score"], len(shapes))
        levels.append([dict(segmentation=masks[k], bbox=boxes[k],
                            predicted_iou=float(iou[k]), stability_score=float(stab[k]))
                       for k in range(len(shapes))])
    return levels


def float16_step(rows: torch.Tensor) -> torch.Tensor:
    """[M, 1]: float16's spacing at the largest magnitude of each row. Rounding to
    float16 moves an element by at most half of it; the float32 products' rounding,
    about a millionth of the row's largest magnitude, would be many steps of float16's
    own spacing at the row's elements nearest zero."""
    _, e = torch.frexp(rows.abs().amax(dim=-1, keepdim=True).clamp(min=2.0 ** -14))
    return torch.ldexp(torch.ones_like(e, dtype=rows.dtype), e - 11)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

class Run:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        cfg, mix = cell.config, cell.mix
        self.views = views_of(cfg, seed, device)
        self.n_views = len(self.views)
        self.masks = [view_masks(cfg, seed, v, device) for v in range(self.n_views)]
        rng = random.Random(seed)
        self.order = list(range(self.n_views))
        rng.shuffle(self.order)
        positions = rng.sample(range(min(self.n_views, mix["traced_views"])),
                               mix["checked_views"])
        self.checked = {self.order[p] for p in positions}
        self.model = build_clip(clip_config(cfg), seed=seed, device=device)
        self.encode = ClipImageEncoder(self.model, device=device,
                                       batch_size=cfg["batch_size"])
        self.program: dict[int, dict] = {}     # view -> its levels' captured outputs
        self.tiles: dict[int, list] = {}       # view -> the tiles a level it encoded
        for i in range(mix["warm_views"]):
            self._embed(self.order[-1 - i])
        program.synchronize(device)

    def _embed(self, v: int, capture: bool = False):
        """`embed_masks` of view v; with `capture`, also the kept records a level and
        each encoder call's tiles and outputs."""
        if not capture:
            embeds, _ = pipeline.embed_masks(self.views[v], self.masks[v], self.encode)
            self.tiles[v] = [len(embeds[lv]) if lv in embeds else 0 for lv in LEVELS]
            return None
        calls, kept = [], []

        def encode(tiles):
            out = self.encode(tiles)
            calls.append((tiles, out))
            return out

        update = pipeline.masks_update

        def update_(*lists, **kw):
            kept.append(update(*lists, **kw))
            return kept[-1]

        pipeline.masks_update = update_
        try:
            embeds, seg_maps = pipeline.embed_masks(self.views[v], self.masks[v], encode)
        finally:
            pipeline.masks_update = update
        self.tiles[v] = [len(embeds[lv]) if lv in embeds else 0 for lv in LEVELS]
        return embeds, seg_maps, calls, kept[0]

    def _outputs(self, v: int, embeds, seg_maps, calls, kept) -> dict:
        out = {}
        for recs, level, kept_lvl in zip(self.masks[v], LEVELS, kept):
            index = {id(r): k for k, r in enumerate(recs)}
            out[level] = dict(kept=[index[id(r)] for r in kept_lvl])
        for level, (tiles, emb) in zip([lv for lv in LEVELS if lv in embeds], calls):
            out[level].update(tiles=tiles, embedding=emb, features=embeds[level],
                              seg_map=seg_maps[level])
        return out

    def _call(self, i: int) -> float:
        v = self.order[i % self.n_views]
        capture = v in self.checked and v not in self.program
        t0 = time.perf_counter()
        got = self._embed(v, capture)
        program.synchronize(self.device)
        latency = time.perf_counter() - t0
        if capture:
            self.program[v] = self._outputs(v, *got)
        return latency

    def window(self, seconds: float) -> dict:
        latencies, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds or not latencies:
            latencies.append(self._call(len(latencies)))
        elapsed = time.perf_counter() - t0
        harness.log_calls("embed_masks", latencies)
        return dict(metrics={"render_views_per_s": len(latencies) / elapsed},
                    attempted=len(latencies), failed=len(self.checked - set(self.program)))

    def traced(self) -> dict:
        """The first `traced_views` calls of the window's order, timed without the
        profiler and then under it, with `masks_update` in the span `bench.mask_nms`,
        `mask_to_segmap` in `bench.clip_tiles` and the encoder in `bench.clip_encoder`."""
        calls = self.cell.mix["traced_views"]
        untraced_s = trace.untraced_seconds(self._call, calls, self.device, lambda: None)
        saved = pipeline.masks_update, pipeline.mask_to_segmap, self.encode
        pipeline.masks_update = trace.spanned("mask_nms", saved[0])
        pipeline.mask_to_segmap = trace.spanned("clip_tiles", saved[1])
        self.encode = trace.spanned("clip_encoder", saved[2])
        try:
            reading = trace.profile(self._call, calls, self.device)
        finally:
            pipeline.masks_update, pipeline.mask_to_segmap, self.encode = saved
        views = [self.order[i % self.n_views] for i in range(calls)]
        return dict(reading=dict(reading, untraced_s=untraced_s), views=views,
                    attempted=calls)

    def work(self, ctx: dict) -> None:
        """Each traced call's masks a level before `masks_update`, the tiles a level it
        encoded, and the view's pixels."""
        cfg = self.cell.config
        ctx["work"] = [dict(config=cfg, masks=[len(recs) for recs in self.masks[v]],
                            tiles=self.tiles[v], pixels=cfg["width"] * cfg["height"])
                       for v in ctx["views"]]
        ctx["kind"] = "embed"

    def release(self) -> None:
        self.model = self.encode = self.masks = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, pr: Precision = FLOAT32, tf32: bool = False,
                  quick_gelu: bool = False) -> dict:
        """The reference's outputs of each checked view's levels, from the views, masks
        and weights it makes again from the seed."""
        ar = ref_clip.Arith(pr, tf32, quick_gelu)
        cfg = self.cell.config
        s = ref_clip.sizes(cfg)
        w = ref_clip.weights(s, self.seed, self.device)
        views = views_of(cfg, self.seed, self.device)
        out = {}
        for v in sorted(self.checked):
            levels = view_masks(cfg, self.seed, v, self.device)
            image = torch.as_tensor(views[v], device=self.device)
            res = {}
            for level, recs, kept in zip(LEVELS, levels, ref_clip.masks_update(levels)):
                res[level] = dict(kept=kept)
                if not kept:
                    continue
                chosen = [recs[k] for k in kept]
                tiles = ref_clip.tiles(image, chosen)
                emb = ref_clip.encode(w, s, tiles, ar)
                unit = emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True) + 1e-12)
                res[level].update(tiles=tiles, embedding=emb, normalised=unit,
                                  features=unit.half(),
                                  seg_map=ref_clip.seg_map(chosen, image.shape[:2]))
            out[v] = res
        return out

    @staticmethod
    def compare(run: dict, ref: dict) -> dict:
        """kept_mismatch (the masks kept by one side alone), tile_mismatch (tile values
        that differ), segmap_mismatch (seg-map pixels that differ), each summed over the
        checked views' levels; embedding_gap, the tower's largest absolute gap over the
        reference's largest magnitude; feature_gap, the float16 features' largest gap
        from the reference's normalised embeddings, in float16 steps at the largest
        magnitude of the reference's row (`float16_step`). A view, level or tensor the
        run lacks, or of another shape, is inf."""
        worst = dict(kept_mismatch=0.0, tile_mismatch=0.0, segmap_mismatch=0.0,
                     embedding_gap=0.0, feature_gap=0.0)

        def differ(a, b):
            return math.inf if a is None or a.shape != b.shape else float((a != b).sum())

        def gap(a, b):
            if a is None or a.shape != b.shape:
                return math.inf
            g = float((a - b).abs().max()) / float(b.abs().max())
            return g if math.isfinite(g) else math.inf

        def steps(a, b):
            if a is None or a.shape != b.shape:
                return math.inf
            g = float(((a.float() - b).abs() / float16_step(b)).max())
            return g if math.isfinite(g) else math.inf

        for v, levels in ref.items():
            got = run.get(v, {})
            for level, r in levels.items():
                p = got.get(level, {})
                kept = p.get("kept")
                worst["kept_mismatch"] += (math.inf if kept is None
                                           else len(set(kept) ^ set(r["kept"])))
                if "tiles" not in r:
                    continue
                worst["tile_mismatch"] += differ(p.get("tiles"), r["tiles"])
                worst["segmap_mismatch"] += differ(p.get("seg_map"), r["seg_map"])
                worst["embedding_gap"] = max(worst["embedding_gap"],
                                             gap(p.get("embedding"), r["embedding"]))
                worst["feature_gap"] = max(worst["feature_gap"],
                                           steps(p.get("features"), r["normalised"]))
        return worst

    def check(self) -> dict:
        return self.compare(self.program, self.reference())
