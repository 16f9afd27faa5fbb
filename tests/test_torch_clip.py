"""PyTorch port, the `transformers` backends against the JAX package's on tiny random
models written to a temporary directory (a SamConfig and a CLIPConfig of narrow widths,
a SamProcessor and a CLIPTokenizer over a small vocabulary; nothing is downloaded): the
SAM predictor's logits and IoUs within 1e-6, the CLIP image and text encoders within
1e-6, both preprocessing CLIs writing the same files, and the eval CLI with
--clip_model against the JAX CLI."""

import json
import os

# local checkpoint directories only: no request may leave the machine
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")

import numpy as np
import jax
import pytest
import torch
from PIL import Image

import chip_smoke
from langsplat_tpu.cli import preprocess_cli as jax_preprocess_cli
from langsplat_tpu.cli.eval_cli import main as jax_eval_main
from langsplat_tpu.evaluation import clip_text as jclip
from langsplat_tpu.preprocess import backends as jbackends
from langsplat_tpu_torch.cli import preprocess_cli
from langsplat_tpu_torch.cli.eval_cli import main as torch_eval_main
from langsplat_tpu_torch.evaluation import clip_text
from langsplat_tpu_torch.preprocess import backends

from tests.test_torch_eval import write_eval_scene

transformers = pytest.importorskip("transformers")

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 1e-6


def make_sam(path, seed=0):
    """A SAM of the sam-vit-huge layout at narrow widths, 64^2 inputs; its IoU head
    biased up and its mask logits (~1e-6 at random weights) scaled up, so that masks
    pass the CLI's IoU (0.7) filter and about half its stability (0.85) filter."""
    torch.manual_seed(seed)
    config = transformers.SamConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                           image_size=64, patch_size=8, output_channels=16,
                           window_size=4, global_attn_indexes=[1], mlp_dim=64,
                           num_pos_feats=8),
        prompt_encoder_config=dict(hidden_size=16, image_size=64, patch_size=8,
                                   mask_input_channels=4),
        mask_decoder_config=dict(hidden_size=16, mlp_dim=32, num_hidden_layers=2,
                                 num_attention_heads=2, iou_head_hidden_dim=16))
    model = transformers.SamModel(config).eval()
    with torch.no_grad():
        model.mask_decoder.iou_prediction_head.proj_out.bias.fill_(2.0)
        for mlp in model.mask_decoder.output_hypernetworks_mlps:
            mlp.proj_out.weight.mul_(3e6)
    model.save_pretrained(path)
    transformers.SamProcessor(transformers.SamImageProcessor(
        size={"longest_edge": 64}, pad_size={"height": 64, "width": 64},
        mask_size={"longest_edge": 16}, mask_pad_size={"height": 16, "width": 16})
    ).save_pretrained(path)


def make_clip(path, seed=0):
    """A CLIP with 512-d projections at narrow widths and a character-level tokenizer
    whose end token has the largest id, as in CLIP's own vocabulary."""
    torch.manual_seed(seed)
    vocab = {}
    for c in "abcdefghijklmnopqrstuvwxyz":
        vocab[c] = len(vocab)
        vocab[c + "</w>"] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    config = transformers.CLIPConfig(
        text_config=dict(vocab_size=len(vocab), hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=32, bos_token_id=len(vocab) - 2,
                         eos_token_id=len(vocab) - 1, pad_token_id=len(vocab) - 1),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=224, patch_size=32),
        projection_dim=512)
    transformers.CLIPModel(config).eval().save_pretrained(path)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
    transformers.CLIPTokenizer(os.path.join(path, "vocab.json"),
                               os.path.join(path, "merges.txt")).save_pretrained(path)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    make_sam(str(root / "sam"))
    make_clip(str(root / "clip"))
    return str(root / "sam"), str(root / "clip")


def test_sam_predictor_equals_jax(models):
    image = chip_smoke.paint_scene(3, 60, 48, (2, 2))
    points = np.array([[10.5, 20.25], [30.0, 40.0], [59.0, 47.0], [0.0, 0.0]])
    jm, ji, jl = jbackends.TransformersSamPredictor(models[0])(image, points)
    pm, pi, pl = backends.TransformersSamPredictor(models[0], device="cpu")(image, points)
    assert pl.shape == (4, 3, 48, 60) and pi.shape == (4, 3) and pm.dtype == torch.bool
    np.testing.assert_allclose(pl.numpy(), jl, atol=ATOL, rtol=0)
    np.testing.assert_allclose(pi.numpy(), ji, atol=ATOL, rtol=0)
    assert np.array_equal(pm.numpy(), jm) or np.abs(jl).min() < ATOL


def test_clip_image_and_text_encoders_equal_jax(models):
    tiles = np.random.default_rng(1).random((5, 3, 224, 224)).astype(np.float32)
    theirs = jbackends.TransformersClipImageEncoder(models[1], batch_size=2)(tiles)
    ours = backends.TransformersClipImageEncoder(models[1], device="cpu", batch_size=2)(
        torch.from_numpy(tiles))
    assert ours.shape == (5, 512)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL, rtol=0)
    prompts = ["a cat", "teapot", "b", "the old brown shoe"]
    theirs = jclip.ClipTextEncoder(models[1])(prompts)
    ours = clip_text.ClipTextEncoder(models[1], device="cpu")(prompts)
    assert ours.dtype == np.float32 and ours.shape == (4, 512)
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)


def test_preprocess_clis_write_the_same_files(models, tmp_path):
    """The JAX CLI (OpenCV, numpy) and the port's on the CPU, with the tiny SAM and
    CLIP: `_s.npy` equal, `_f.npy` within one float16 unit."""
    for side in ("jax", "port"):
        (tmp_path / side / "images").mkdir(parents=True)
        for v in range(2):
            Image.fromarray(chip_smoke.paint_scene(30 + v, 64, 48, (2, 2))).save(
                tmp_path / side / "images" / f"view_{v}.png")
    argv = ["--sam_model", models[0], "--clip_model", models[1], "--points_per_side", "4",
            "--device", "cpu"]
    jax_preprocess_cli.main(["--dataset_path", str(tmp_path / "jax")] + argv)
    preprocess_cli.main(["--dataset_path", str(tmp_path / "port")] + argv)
    files = sorted(os.listdir(tmp_path / "jax" / "language_features"))
    assert files == sorted(os.listdir(tmp_path / "port" / "language_features"))
    assert len(files) == 4
    for f in files:
        a = np.load(tmp_path / "jax" / "language_features" / f)
        b = np.load(tmp_path / "port" / "language_features" / f)
        assert a.dtype == b.dtype and a.shape == b.shape
        if f.endswith("_s.npy"):
            np.testing.assert_array_equal(b, a)
        else:
            assert chip_smoke.float16_units(b, a) <= 1


def test_eval_cli_with_clip_model_equals_jax(models, tmp_path):
    """--clip_model <tiny CLIP> in place of --text_embeddings: the same IoUs, levels
    and localization as the JAX CLI, and as the port's CLI given the JAX encoder's
    embeddings as --text_embeddings (the random CLIP scores the cup nowhere: mIoU 0)."""
    args = write_eval_scene(tmp_path)[:-2] + ["--no_vis"]
    prompts = ["cup", "object", "things", "stuff", "texture"]
    np.savez(tmp_path / "clip_text.npz",
             **dict(zip(prompts, jclip.ClipTextEncoder(models[1])(prompts))))
    theirs = jax_eval_main(args + ["--clip_model", models[1], "--output_dir",
                                   str(tmp_path / "jax")])
    results = [torch_eval_main(args + [flag, value, "--output_dir", str(tmp_path / flag),
                                       "--device", "cpu"])
               for flag, value in (("--clip_model", models[1]),
                                   ("--text_embeddings", str(tmp_path / "clip_text.npz")))]
    for ours in results:
        assert ours["miou"] == theirs["miou"]
        assert ours["chosen_levels"] == theirs["chosen_levels"]
        assert ours["localization_acc"] == theirs["localization_acc"]
        assert [f["ious"] for f in ours["frames"]] == [f["ious"] for f in results[0]["frames"]]
