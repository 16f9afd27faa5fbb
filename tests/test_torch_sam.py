"""PyTorch port, SAM (`models/sam.py`) at a small size that keeps every kind of block
(an 8x8 token grid, windows of 3 padded to 9, global blocks 1 and 3 of 4, decoder width
32): against the benchmark's plain reference (`bench_port/reference/sam.py`) on seeded
random weights, against `transformers`' SamModel through the checkpoint loader, and the
mask generator's encode-once path against the per-batch path, with its counters.

Tolerances: every gap is the largest absolute gap over the reference's largest
magnitude. The two sides sum in other orders (windows and heads one at a time, einsum
against gathers, convolutions as products), so float32 rounding leaves ~2e-6 after four
blocks; 2e-5 allows ten times that. TF32's rounding of the products' operands to 10
mantissa bits moves the same numbers by ~1e-3, and leaving the global blocks'
relative-position term out by ~0.1-0.6: both fail the tolerance, as the tests check.
"""

import json
import os
from pathlib import Path

# local checkpoint directories only: no request may leave the machine
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import numpy as np
import pytest
import torch
from PIL import Image

from bench_port.reference import sam as ref
from langsplat_tpu_torch.models import sam
from langsplat_tpu_torch.preprocess import backends
from langsplat_tpu_torch.preprocess.auto_mask import AutoMaskConfig, AutoMaskGenerator
from langsplat_tpu_torch.utils.tracing import COUNTERS

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CONFIG = json.loads((ROOT / "bench_port" / "tests" / "tiny_sam.json").read_text())
SEED = 2**31 + 101
TOL = 2e-5
CPU = torch.device("cpu")


def program_config(cfg=CONFIG) -> sam.SamConfig:
    from bench_port.drivers.preprocess import sam_config
    return sam_config(cfg)


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def view(seed=3, h=96, w=128) -> np.ndarray:
    """A smooth random colour image, as the benchmark's views are."""
    low = torch.rand((1, 3, h // 16, w // 16), generator=torch.Generator().manual_seed(seed))
    img = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear")
    return (img[0].permute(1, 2, 0) * 255).round().to(torch.uint8).numpy()


@pytest.fixture(scope="module")
def model():
    return sam.build_sam(program_config(), seed=SEED)


@pytest.fixture(scope="module")
def weights():
    return ref.weights(ref.sizes(CONFIG), SEED, CPU)


@pytest.mark.parametrize("sizes", [(48, 60, 64, 80), (100, 37, 33, 12), (391, 600, 667, 1024),
                                   (97, 131, 45, 200), (96, 128, 96, 128)])
def test_resizes_equal_pil(sizes):
    """The port's and the reference's bilinear uint8 resize, bit for bit PIL's."""
    h, w, oh, ow = sizes
    img = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    pil = np.array(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    port = sam.resize_bilinear_uint8(torch.from_numpy(img), oh, ow).numpy()
    plain = ref.resize_uint8(torch.from_numpy(img), oh, ow).numpy()
    np.testing.assert_array_equal(port, pil)
    np.testing.assert_array_equal(plain, pil)


def test_random_weights_are_the_references_draw(model, weights):
    state = model.state_dict()
    assert state.keys() == weights.keys()
    for k, v in state.items():
        assert torch.equal(v, weights[k]), k


def crops_of(image):
    h, w = image.shape[:2]
    return [image[y0:y1, x0:x1] for x0, y0, x1, y1 in ref.crop_boxes(
        h, w, CONFIG["crop_n_layers"], AutoMaskConfig().crop_overlap_ratio)]


@pytest.mark.parametrize("crop", range(5))
def test_encoder_and_decoder_match_the_reference(model, weights, crop):
    """The embedding, the low-res logits, the IoU predictions and the crop-size logits
    of one crop and 8 points, through the predictor."""
    image = crops_of(view())[crop]
    s = ref.sizes(CONFIG)
    pred = backends.SamPredictor(model, device="cpu")
    points = ref.point_grid(4)[:8] * np.array([image.shape[1], image.shape[0]])
    pred.set_image(image)
    low, iou = pred.decode(points)
    logits = pred.upscale(low)
    emb, in_size = ref.embed(weights, s, torch.from_numpy(image))
    assert tuple(in_size) == tuple(pred.input_size)
    r_low, r_iou = ref.decode(weights, s, emb, points, image.shape[:2], in_size)
    r_logits = ref.upscale(r_low, s, in_size, image.shape[:2])
    assert logits.shape == (8, 3, *image.shape[:2]) and low.shape == (8, 3, 32, 32)
    for ours, theirs in ((pred.embedding[0], emb), (low, r_low), (iou, r_iou),
                         (logits, r_logits)):
        assert gap(ours, theirs) < TOL


@pytest.mark.parametrize("arith", ["tf32", "no_global_rel_pos"])
def test_a_lower_precision_or_a_missing_term_fails_the_tolerance(model, weights, arith):
    image = crops_of(view())[0]
    s = ref.sizes(CONFIG)
    ar = ref.Arith(tf32=True) if arith == "tf32" else ref.Arith(global_rel_pos=False)
    emb, _ = ref.embed(weights, s, torch.from_numpy(image))
    other, _ = ref.embed(weights, s, torch.from_numpy(image), ar)
    assert gap(other, emb) > 10 * TOL


def sharp(model: sam.Sam) -> sam.Sam:
    """The model with its IoU head biased up and its mask logits scaled up, so that
    masks pass the CLI's IoU (0.7) and stability (0.85) filters."""
    with torch.no_grad():
        model.mask_decoder.iou_prediction_head.layers[-1].bias.fill_(2.0)
        for mlp in model.mask_decoder.output_hypernetworks_mlps:
            mlp.layers[-1].weight.mul_(200.0)
    return model


def test_generate_encodes_each_crop_once_and_equals_the_per_batch_path():
    """One `generate` through the predictor's encode-once path and through the
    per-batch path (the plain `predictor(crop, points)` callable, which encodes again
    for every batch): the same records; 5 encoder passes against 5 x 2."""
    pred = backends.SamPredictor(sharp(sam.build_sam(program_config(), seed=SEED)),
                                 device="cpu")
    cfg = AutoMaskConfig(**{k: CONFIG[k] for k in (
        "points_per_side", "points_per_batch", "pred_iou_thresh",
        "stability_score_thresh", "box_nms_thresh", "crop_n_layers",
        "min_mask_region_area")})
    image = view(seed=5)
    runs = {}
    for name, predictor in (("once", pred), ("per_batch", lambda c, p: pred(c, p))):
        before = dict(COUNTERS)
        out = AutoMaskGenerator(predictor, cfg, device="cpu").generate(image)
        runs[name] = out, {k: COUNTERS[k] - before[k] for k in COUNTERS}
    (once, n1), (per_batch, n2) = runs["once"], runs["per_batch"]
    assert sum(len(recs) for recs in once) > 0
    for a, b in zip(once, per_batch):
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            assert torch.equal(ra["segmentation"], rb["segmentation"])
            assert np.array_equal(ra["bbox"], rb["bbox"])
            for key in ("predicted_iou", "stability_score", "point_coords", "crop_box"):
                assert ra[key] == rb[key]
    batches = 5 * -(-CONFIG["points_per_side"] ** 2 // CONFIG["points_per_batch"])
    assert n1["sam.encoder_passes"] == 5 and n2["sam.encoder_passes"] == batches
    assert n1["sam.decoder_batches"] == n2["sam.decoder_batches"] == batches
    assert n1["sam.prompts"] == 5 * CONFIG["points_per_side"] ** 2
    kept = len({id(r) for recs in once for r in recs})
    assert n1["sam.masks_kept"] == n2["sam.masks_kept"] == kept


@pytest.fixture(scope="module")
def hf_sam(tmp_path_factory):
    """A `transformers` SamModel at the tiny widths with every tensor drawn at random
    (its own initialisation leaves the weights near zero), written to a directory."""
    transformers = pytest.importorskip("transformers")
    path = tmp_path_factory.mktemp("sam")
    c = CONFIG
    config = transformers.SamConfig(
        vision_config=dict(hidden_size=c["encoder_embed_dim"],
                           num_hidden_layers=c["encoder_depth"],
                           num_attention_heads=c["encoder_num_heads"],
                           image_size=c["image_size"], patch_size=c["patch_size"],
                           output_channels=c["prompt_embed_dim"],
                           window_size=c["window_size"],
                           global_attn_indexes=c["encoder_global_attn_indexes"],
                           mlp_dim=c["encoder_embed_dim"] * c["mlp_ratio"],
                           num_pos_feats=c["prompt_embed_dim"] // 2),
        prompt_encoder_config=dict(hidden_size=c["prompt_embed_dim"],
                                   image_size=c["image_size"],
                                   patch_size=c["patch_size"], mask_input_channels=4),
        mask_decoder_config=dict(hidden_size=c["prompt_embed_dim"],
                                 mlp_dim=c["decoder_mlp_dim"],
                                 num_hidden_layers=c["decoder_depth"],
                                 num_attention_heads=c["decoder_num_heads"],
                                 iou_head_hidden_dim=c["iou_head_hidden_dim"]))
    torch.manual_seed(7)
    model = transformers.SamModel(config).eval()
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if t.dim() == 1:
                t.copy_(1 + 0.1 * torch.randn_like(t) if name.endswith("weight")
                        else 0.02 * torch.randn_like(t))
            else:
                t.copy_(torch.randn_like(t) / max(t[0].numel(), 1) ** 0.5)
        model.shared_image_embedding.positional_embedding.normal_()
        model.prompt_encoder.shared_embedding.positional_embedding.copy_(
            model.shared_image_embedding.positional_embedding)
    model.save_pretrained(str(path))
    s = c["image_size"]
    transformers.SamProcessor(transformers.SamImageProcessor(
        size={"longest_edge": s}, pad_size={"height": s, "width": s},
        mask_size={"longest_edge": s // 4}, mask_pad_size={"height": s // 4, "width": s // 4})
    ).save_pretrained(str(path))
    return str(path), model


def test_the_loader_matches_transformers(hf_sam):
    """The directory loaded into the port's SAM: the same embeddings, low-res masks
    and IoU predictions as `transformers`' own forward on the same pixels and points."""
    path, theirs = hf_sam
    ours = sam.load_sam(path)
    assert ours.cfg.decoder_norm_eps == 1e-6
    image = torch.from_numpy(view(seed=9))
    pixels, size = ours.preprocess(image)
    points = torch.tensor([[10.5, 20.25], [100.0, 70.0], [127.0, 95.0], [0.0, 0.0]])
    with torch.no_grad():
        emb = theirs.get_image_embeddings(pixels)
        out = theirs(image_embeddings=emb, input_points=points[None, :, None],
                     multimask_output=True)
    mine = ours.embed(pixels)
    low, iou = ours.decode(mine, points)
    assert gap(mine, emb) < TOL
    assert gap(low, out.pred_masks[0]) < TOL
    assert gap(iou, out.iou_scores[0]) < TOL


def test_the_predictor_matches_transformers_predictor(hf_sam):
    """`SamPredictor` and `TransformersSamPredictor` (the processor's resize,
    normalisation, coordinates and `post_process_masks`) on a crop-sized image."""
    path, _ = hf_sam
    image = view(seed=11, h=64, w=80)
    points = np.array([[10.5, 20.25], [30.0, 40.0], [79.0, 63.0]])
    _, iou, logits = backends.SamPredictor(path, device="cpu")(image, points)
    _, t_iou, t_logits = backends.TransformersSamPredictor(path, device="cpu")(image, points)
    assert logits.shape == t_logits.shape == (3, 3, 64, 80)
    assert gap(logits, t_logits) < TOL
    assert gap(iou, t_iou) < TOL
