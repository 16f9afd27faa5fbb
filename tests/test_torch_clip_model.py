"""PyTorch port, CLIP's image tower (`models/clip.py`) and the mask-to-embedding stage
(`preprocess/pipeline.py embed_masks`) at the benchmark's tiny size
(`bench_port/tests/tiny_clip.json`: 224^2 tiles in 7 x 7 patches of 32, width 32, 2
blocks of 2 heads, MLP 64): against the benchmark's plain reference
(`bench_port/reference/clip.py`) on seeded random weights and seeded masks, against
`transformers`' CLIPModel through the checkpoint loader, and the stage's spans and
counters.

Tolerances: a gap is the largest absolute gap over the reference's largest magnitude.
The two sides sum in other orders (q, k and v in one product against one head at a
time, a convolution against a product of unfolded patches), so float32 rounding leaves
~1e-6 after two blocks; TOL = 2e-5 allows ten times that. TF32's rounding of the
products' operands to 10 mantissa bits moves the same numbers by ~7e-4, bfloat16 by
~6e-3, QuickGELU in place of the exact GELU by ~7e-3: each fails TOL, as the tests
check. Against `transformers` (the same products in another grouping): 1e-6 absolute.
The NMS, the tiles and the seg maps are integer work and are held equal; the float16
features within one float16 step (at each row's largest magnitude) of the reference's
normalised embeddings.
"""

import ast
import json
import os
from pathlib import Path

# local checkpoint directories only: no request may leave the machine
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from bench_port.drivers.embed import clip_config, float16_step, view_masks
from bench_port.drivers.preprocess import views_of
from bench_port.reference import Precision
from bench_port.reference import clip as ref
from langsplat_tpu_torch.models import clip
from langsplat_tpu_torch.preprocess import backends, masks, pipeline
from langsplat_tpu_torch.preprocess.auto_mask import AutoMaskConfig, AutoMaskGenerator
from langsplat_tpu_torch.utils import tracing
from langsplat_tpu_torch.utils.tracing import COUNTERS

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "bench_port" / "tests" / "tiny_clip.json").read_text())
SEED = 2**31 + 313
TOL = 2e-5
HF_ATOL = 1e-6
CPU = torch.device("cpu")


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def tiles(n=5, seed=4) -> torch.Tensor:
    """[n, 3, 224, 224] in [0, 1], as the tiles' x / 255 values are."""
    u8 = torch.randint(0, 256, (n, 3, 224, 224), generator=torch.Generator().manual_seed(seed))
    return u8.float() / 255


@pytest.fixture(scope="module")
def model():
    return clip.build_clip(clip_config(CONFIG), seed=SEED)


@pytest.fixture(scope="module")
def weights():
    return ref.weights(ref.sizes(CONFIG), SEED, CPU)


def test_random_weights_are_the_references_draw(model, weights):
    state = model.state_dict()
    assert state.keys() == weights.keys()
    for k, v in state.items():
        assert torch.equal(v, weights[k]), k


def test_the_tower_matches_the_reference(model, weights):
    t = tiles()
    ours = backends.ClipImageEncoder(model, device="cpu", batch_size=2)(t)
    theirs = ref.encode(weights, ref.sizes(CONFIG), t)
    assert ours.shape == theirs.shape == (5, CONFIG["embed_dim"])
    assert gap(ours, theirs) < TOL


@pytest.mark.parametrize("arith", ["tf32", "bfloat16", "quick_gelu"])
def test_a_lower_precision_or_another_activation_fails_the_tolerance(weights, arith):
    t, s = tiles(3), ref.sizes(CONFIG)
    ar = {"tf32": ref.Arith(tf32=True), "bfloat16": ref.Arith(pr=Precision("bfloat16")),
          "quick_gelu": ref.Arith(quick_gelu=True)}[arith]
    assert gap(ref.encode(weights, s, t, ar), ref.encode(weights, s, t)) > 10 * TOL


def test_the_published_config_builds_on_meta_with_its_parameter_count():
    with torch.device("meta"):
        model = clip.ClipVision(clip.ClipVisionConfig())
    assert sum(p.numel() for p in model.parameters()) == 86_192_640
    cfg = clip_config(json.loads(
        (ROOT / "bench_port" / "configs" / "clip-vit-b16.json").read_text()))
    assert cfg == clip.ClipVisionConfig()


def test_the_model_imports_no_transformers():
    tree = ast.parse((ROOT / "langsplat_tpu_torch" / "models" / "clip.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m and m.split(".")[0] == "transformers"]


# ---------------------------------------------------------------------------
# The loader against transformers
# ---------------------------------------------------------------------------

def write_hf_clip(path, act: str | None):
    """A `transformers` CLIPModel at the tiny widths with every tensor drawn at random
    (its own initialisation leaves the weights near zero), written to a directory;
    `act` None leaves `hidden_act` at transformers' default (QuickGELU)."""
    transformers = pytest.importorskip("transformers")
    v = clip_config(CONFIG)
    vision = dict(hidden_size=v.width, intermediate_size=v.mlp_dim, num_hidden_layers=v.layers,
                  num_attention_heads=v.heads, image_size=v.image_size,
                  patch_size=v.patch_size)
    if act is not None:
        vision["hidden_act"] = act
    config = transformers.CLIPConfig(
        text_config=dict(hidden_size=16, intermediate_size=32, num_hidden_layers=1,
                         num_attention_heads=2), vision_config=vision,
        projection_dim=v.output_dim)
    torch.manual_seed(7)
    model = transformers.CLIPModel(config).eval()
    with torch.no_grad():
        for name, t in model.vision_model.named_parameters():
            if t.dim() == 1:
                t.copy_(1 + 0.1 * torch.randn_like(t) if name.endswith("weight")
                        else 0.02 * torch.randn_like(t))
            else:
                t.copy_(torch.randn_like(t) / max(t[0].numel(), 1) ** 0.5)
        model.visual_projection.weight.normal_(0, v.width ** -0.5)
    model.save_pretrained(str(path))
    return model


@pytest.mark.parametrize("act", [None, "gelu"])
def test_the_loader_matches_transformers(tmp_path, act):
    """The directory loaded into the port's tower: the same image features as
    `transformers`' own forward, with the activation its config names (QuickGELU by
    default, the exact GELU as the laion checkpoint's config says)."""
    theirs = write_hf_clip(tmp_path, act)
    ours = clip.load_clip(str(tmp_path))
    assert ours.cfg.act == (act or "quick_gelu") and ours.cfg.patch_size == 32
    pixels = (tiles(3) - 0.45) / 0.27
    with torch.no_grad():
        expected = backends.image_features(theirs, pixels)
    assert (ours.embed(pixels) - expected).abs().max() < HF_ATOL


def test_the_encoder_matches_transformers_encoder(tmp_path):
    write_hf_clip(tmp_path, "gelu")
    t = tiles(5)
    ours = backends.ClipImageEncoder(str(tmp_path), device="cpu", batch_size=2)(t)
    theirs = backends.TransformersClipImageEncoder(str(tmp_path), device="cpu",
                                                   batch_size=2)(t)
    assert ours.shape == theirs.shape == (5, CONFIG["embed_dim"])
    assert (ours - theirs).abs().max() < HF_ATOL


def test_the_encoder_needs_a_card_unless_asked(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.ClipImageEncoder(model)
    assert backends.ClipImageEncoder(model, device="cpu").device == CPU


# ---------------------------------------------------------------------------
# embed_masks against the reference
# ---------------------------------------------------------------------------

def kept_indices(levels, updated):
    return [[[id(r) for r in recs].index(id(k)) for k in kept]
            for recs, kept in zip(levels, updated)]


def float16_steps(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.float() - b).abs() / float16_step(b)).max())


@pytest.mark.parametrize("view", [0, 1])
def test_embed_masks_equals_the_reference(model, weights, view):
    """The kept masks, the tiles, the seg maps, the tower's outputs and the float16
    features of one seeded view's seeded masks."""
    levels = view_masks(CONFIG, SEED, view, CPU)
    image = views_of(CONFIG, SEED, CPU)[view]
    encoder = backends.ClipImageEncoder(model, device="cpu", batch_size=CONFIG["batch_size"])
    kept = ref.masks_update(levels)
    assert kept_indices(levels, masks.masks_update(*levels)) == kept
    assert all(0 < len(k) < len(recs) for k, recs in zip(kept, levels))
    embeds, seg_maps = pipeline.embed_masks(image, levels, encoder)
    img, s = torch.from_numpy(image), ref.sizes(CONFIG)
    for level, recs, k in zip(ref.LEVELS, levels, kept):
        chosen = [recs[i] for i in k]
        r_tiles = ref.tiles(img, chosen)
        ours, seg = masks.mask_to_segmap(chosen, img)
        assert torch.equal(ours, r_tiles)
        assert torch.equal(seg, ref.seg_map(chosen, img.shape[:2]))
        assert torch.equal(seg_maps[level], seg)
        r_emb = ref.encode(weights, s, r_tiles)
        assert gap(encoder(ours), r_emb) < TOL
        unit = r_emb / (torch.linalg.vector_norm(r_emb, dim=-1, keepdim=True) + 1e-12)
        assert embeds[level].dtype == torch.float16
        assert float16_steps(embeds[level], unit) <= 1.0


def test_embed_image_is_generate_then_embed_masks():
    image = chip_smoke.paint_scene(13, 128, 96, (4, 3))
    gen = AutoMaskGenerator(chip_smoke.StandInPredictor(0, "cpu"),
                            AutoMaskConfig(points_per_side=8, crop_n_layers=1), device="cpu")
    enc = chip_smoke.StandInEncoder(0, "cpu")
    embeds, seg_maps = pipeline.embed_image(image, gen, enc)
    e2, s2 = pipeline.embed_masks(image, gen.generate(image), enc)
    assert embeds.keys() == e2.keys() and seg_maps.keys() == s2.keys() and embeds
    for k in embeds:
        assert torch.equal(embeds[k], e2[k]) and torch.equal(seg_maps[k], s2[k])


def test_the_stage_is_traced_and_counted(model):
    """One `embed_masks` under a CPU profiler: the root span `embed_masks` holding
    `masks_update` (one `mask_nms` a level, each with its counted syncs), `clip_tiles`
    a level and `clip_encoder` a batch; the counters move by the masks in and kept, the
    tiles and the passes."""
    levels = view_masks(CONFIG, SEED, 2, CPU)
    image = views_of(CONFIG, SEED, CPU)[2]
    encoder = backends.ClipImageEncoder(model, device="cpu", batch_size=CONFIG["batch_size"])
    tracing.end_session()
    before = dict(COUNTERS)
    with profile(activities=[ProfilerActivity.CPU]):
        embeds, _ = pipeline.embed_masks(image, levels, encoder)
    moved = {k: v - before[k] for k, v in COUNTERS.items()}
    s = tracing.session()
    assert s.of_calls("embed_masks", 1)
    root = s.roots()[0]
    child_names = [x.name for x in s.spans if x.parent == root.id]
    kept = [len(e) for e in embeds.values()]
    batches = sum(-(-n // CONFIG["batch_size"]) for n in kept)
    assert child_names.count("masks_update") == 1
    assert child_names.count("clip_tiles") == len(kept) == 4
    update = next(x for x in s.spans if x.name == "masks_update")
    nms = [x for x in s.spans if x.parent == update.id]
    assert [x.name for x in nms] == ["mask_nms"] * 4
    syncs = sorted({x.name for x in s.spans if x.name.startswith("sync.mask_nms.")})
    assert syncs == ["sync.mask_nms.conf", "sync.mask_nms.inner_l", "sync.mask_nms.inner_u",
                     "sync.mask_nms.keep", "sync.mask_nms.order"]
    assert sum(x.name == "clip_encoder" for x in s.spans) == batches
    assert moved["mask_nms.masks"] == sum(len(recs) for recs in levels)
    assert moved["mask_nms.kept"] == moved["clip.tiles"] == sum(kept)
    assert moved["clip.encoder_batches"] == batches
    assert moved["host_syncs"] == 1 + 5 * 4 + 2 * 4
