"""PyTorch port, the LERF eval: relevancy against the JAX package (1e-6), the cv2-free
polygon fill and filters against OpenCV and the JAX package, the protocol and the eval
CLI against JAX's on synthetic labelme scenes, the colormap table and PNG writers, the
device rule, and the CLIs in an interpreter without OpenCV and matplotlib."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from langsplat_tpu.cli.eval_cli import main as jax_eval_main
from langsplat_tpu.evaluation import colormaps as jcm
from langsplat_tpu.evaluation import iou_loc as jiou
from langsplat_tpu.evaluation import relevancy as jrel
from langsplat_tpu.evaluation import viz as jviz
from langsplat_tpu.models.autoencoder import init_autoencoder as jax_init
from langsplat_tpu_torch.cli.eval_cli import main as torch_eval_main
from langsplat_tpu_torch.evaluation import colormaps, iou_loc, relevancy, viz

from tests.test_evaluation import make_labelme_scene

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
REL_ATOL = 1e-6       # relevancy probabilities: float32 products of unit vectors


def unit(rng, *shape):
    x = rng.normal(size=shape)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# relevancy
# ---------------------------------------------------------------------------

def test_relevancy_matches_jax_with_a_tie():
    rng = np.random.default_rng(0)
    embeds, pos, neg = unit(rng, 300, 512), unit(rng, 3, 512), unit(rng, 4, 512)
    neg[2] = neg[1]                     # two negatives tie: argmin keeps the first
    for k in range(3):
        ours = relevancy.relevancy(torch.from_numpy(embeds), torch.from_numpy(pos[k]),
                                   torch.from_numpy(neg)).numpy()
        theirs = np.asarray(jrel.relevancy(embeds, pos[k], neg))
        np.testing.assert_allclose(ours, theirs, atol=REL_ATOL)
    # the tie's index: the first of the equal negatives
    sims = torch.from_numpy(embeds @ neg.T)
    pairs = torch.stack([sims[:, 1:2].expand(-1, 2), sims[:, 1:3]], dim=-1)
    probs = torch.softmax(10 * pairs, dim=-1)[..., 0]
    assert (torch.argmin(probs, dim=1) == 0).all()


def test_get_max_across_and_semantic_map_match_jax():
    rng = np.random.default_rng(1)
    sem, pos, neg = unit(rng, 3, 8, 10, 512), unit(rng, 5, 512), unit(rng, 4, 512)
    pos[3] = 0.3 * pos[3] + neg[0]      # some pixels where a negative wins
    pos[3] /= np.linalg.norm(pos[3])
    ours = relevancy.get_max_across(*map(torch.from_numpy, (sem, pos, neg))).numpy()
    theirs = np.asarray(jrel.get_max_across(sem, pos, neg))
    assert ours.shape == (3, 5, 8, 10)
    np.testing.assert_allclose(ours, theirs, atol=REL_ATOL)
    ids = relevancy.semantic_map(*map(torch.from_numpy, (sem, pos, neg))).numpy()
    np.testing.assert_array_equal(ids, np.asarray(jrel.semantic_map(sem, pos, neg)))
    assert (ids == -1).any() and (ids >= 0).any()


# ---------------------------------------------------------------------------
# polygon fill and filters
# ---------------------------------------------------------------------------

def random_polygon(kind, rng, h, w):
    n = int(rng.integers(20, 60)) if kind != "self-intersecting" else int(rng.integers(3, 30))
    c = np.array([w, h]) / 2
    if kind == "convex":
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(3, min(h, w) / 2)
        return c + r * np.stack([np.cos(ang), np.sin(ang)], 1)
    if kind == "concave":
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(2, min(h, w) / 2, (n, 1))
        return c + r * np.stack([np.cos(ang), np.sin(ang)], 1)
    if kind == "self-intersecting":
        return rng.uniform([0, 0], [w, h], (n, 2))
    if kind == "degenerate":        # repeated points, collinear runs, slivers
        pts = rng.uniform([0, 0], [w, h], (n, 2))
        pts[1::2] = pts[0::2][:len(pts[1::2])]
        pts[2] = 0.5 * (pts[0] + pts[4])
        return pts
    # partly outside the image (labelme points reach past the border)
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(0.3, 0.7, (n, 1)) * min(h, w)
    return rng.uniform([0, 0], [w, h]) + r * np.stack([np.cos(ang), np.sin(ang)], 1)


@pytest.mark.parametrize("kind", ["convex", "concave", "self-intersecting", "degenerate"])
def test_polygon_to_mask_equals_cv2_fillpoly(kind):
    """Bit for bit, float labelme points truncated to int32 as the JAX package does."""
    rng = np.random.default_rng(["convex", "concave", "self-intersecting",
                                 "degenerate"].index(kind))
    for _ in range(60):
        h, w = int(rng.integers(16, 160)), int(rng.integers(16, 200))
        pts = random_polygon(kind, rng, h, w)
        ref = jiou.polygon_to_mask((h, w), pts.tolist())
        np.testing.assert_array_equal(iou_loc.polygon_to_mask((h, w), pts.tolist()), ref)


def test_polygon_to_mask_partly_outside_differs_only_on_the_border():
    """Where a polygon leaves the image, OpenCV 5.0 clips its edges and projects their
    outside parts onto the border; the port's fill does the same, so no pixel differs,
    on the border or elsewhere: 80 polygons reaching past the border, and each again
    with some vertices moved to exactly x = W and y = H (labelme points on the right or
    bottom edge, which truncate to a column or row outside the image)."""
    rng = np.random.default_rng(4)
    for _ in range(80):
        h, w = int(rng.integers(60, 200)), int(rng.integers(60, 240))
        pts = random_polygon("outside", rng, h, w)
        on_edge = pts.copy()
        on_edge[::3, 0] = w
        on_edge[1::4, 1] = h
        for p in (pts, on_edge):
            ref = jiou.polygon_to_mask((h, w), p.tolist())
            np.testing.assert_array_equal(iou_loc.polygon_to_mask((h, w), p.tolist()), ref)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_polygon_to_mask_outside_equals_cv2_fillpoly(seed):
    """Bit for bit on polygons that leave the image: 60 large ones of the kind above,
    and 400 small images whose vertices lie up to 40 px outside on any side, so that
    edges cross one, two or no borders, corners included."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        h, w = int(rng.integers(60, 200)), int(rng.integers(60, 240))
        pts = random_polygon("outside", rng, h, w)
        ref = jiou.polygon_to_mask((h, w), pts.tolist())
        np.testing.assert_array_equal(iou_loc.polygon_to_mask((h, w), pts.tolist()), ref)
    for _ in range(400):
        h, w = (int(v) for v in rng.integers(3, 16, 2))
        n, spread = int(rng.integers(3, 8)), int(rng.choice([6, 40]))
        pts = np.stack([rng.integers(-spread, w + spread, n),
                        rng.integers(-spread, h + spread, n)], 1)
        ref = jiou.polygon_to_mask((h, w), pts.tolist())
        np.testing.assert_array_equal(iou_loc.polygon_to_mask((h, w), pts.tolist()), ref)


def test_mean_filter_30_matches_cv2_filter2d():
    rng = np.random.default_rng(5)
    for shape in [(48, 64), (31, 33), (2, 3, 70, 45)]:
        x = rng.uniform(0, 1, shape).astype(np.float32)
        ours = iou_loc.mean_filter_30(torch.from_numpy(x)).numpy()
        ref = np.stack([jiou.mean_filter_30(m) for m in x.reshape(-1, *shape[-2:])])
        assert ours.dtype == np.float32
        np.testing.assert_allclose(ours, ref.reshape(shape), atol=2e-6, rtol=0)


def test_mode_filter_bit_equal_to_jax():
    rng = np.random.default_rng(6)
    masks = (rng.uniform(size=(2, 3, 37, 41)) > 0.55).astype(np.uint8)
    ours = iou_loc.mode_filter(torch.from_numpy(masks)).numpy()
    theirs = np.stack([jiou.mode_filter(m) for m in masks.reshape(-1, 37, 41)])
    np.testing.assert_array_equal(ours, theirs.reshape(masks.shape))
    for shape in [(7, 9), (5, 5)]:
        m = (rng.uniform(size=shape) > 0.5).astype(np.uint8)
        np.testing.assert_array_equal(iou_loc.mode_filter(torch.from_numpy(m)).numpy(),
                                      jiou.mode_filter(m))


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------

def test_activate_stream_and_localization_match_jax():
    """The synthetic map of tests/test_evaluation.py (a clear peak on level 1) and a
    second prompt whose peak sits outside its box: equal IoUs, levels and counts."""
    h, w = 64, 80
    valid_map = np.full((3, 2, h, w), 0.05, np.float32)
    valid_map[1, 0, 10:31, 10:31] = 0.95
    valid_map[2, 1, 40:60, 50:75] = 0.8
    valid_map[0, 1, 45:50, 5:15] = 0.5
    gt = np.zeros((2, h, w), np.uint8)
    gt[0, 10:31, 10:31] = 1
    gt[1, 5:20, 5:20] = 1
    img_ann = {"cup": {"mask": gt[0], "bboxes": np.array([10, 10, 30, 30])},
               "tea": {"mask": gt[1], "bboxes": np.array([[5, 5, 19, 19],
                                                          [0, 0, 3, 3]])}}
    ours = iou_loc.activate_stream(torch.from_numpy(valid_map), img_ann, ["cup", "tea"],
                                   thresh=0.4)
    theirs = jiou.activate_stream(valid_map, img_ann, ["cup", "tea"], thresh=0.4)
    assert ours[0] == theirs[0] and ours[1] == theirs[1] == [1, 2]
    np.testing.assert_array_equal(ours[3].numpy(), theirs[3])
    np.testing.assert_allclose(ours[2].numpy(), theirs[2], atol=1e-6)
    acc = iou_loc.lerf_localization(torch.from_numpy(valid_map), img_ann, ["cup", "tea"])
    assert acc == jiou.lerf_localization(valid_map, img_ann, ["cup", "tea"]) == 1


def test_masks_on_random_maps_flip_rarely():
    """Random smooth relevancy maps: the mean filter agrees with OpenCV's to ~6e-8, so
    a pixel within that of the threshold can flip. Held: under 1e-4 of the mask pixels,
    and the same chosen levels; the share is printed."""
    rng = np.random.default_rng(7)
    coarse = rng.uniform(0.3, 0.7, (3, 4, 7, 9)).astype(np.float32)
    valid_map = np.kron(coarse, np.ones((8, 8), np.float32)) \
        + 0.05 * rng.uniform(size=(3, 4, 56, 72)).astype(np.float32)
    gt = (rng.uniform(size=(4, 56, 72)) > 0.5).astype(np.uint8)
    names = [f"p{k}" for k in range(4)]
    img_ann = {n: {"mask": gt[k], "bboxes": np.array([10, 10, 40, 30])}
               for k, n in enumerate(names)}
    ours = iou_loc.activate_stream(torch.from_numpy(valid_map), img_ann, names, thresh=0.4)
    theirs = jiou.activate_stream(valid_map, img_ann, names, thresh=0.4)
    flipped = float((ours[3].numpy() != theirs[3]).mean())
    print(f"flipped mask share on random maps: {flipped:.2e}")
    assert flipped < 1e-4
    assert ours[1] == theirs[1]
    np.testing.assert_allclose(ours[0], theirs[0], atol=1e-3)


def identity_ae_leaves():
    """AE leaves whose decoder maps a non-negative latent z to z padded with zeros
    (each kernel an identity block, biases 0), then normalized."""
    _, variables = jax_init(jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    leaves = []
    for path, x in flat:
        name = jax.tree_util.keystr(path)
        x = np.asarray(x)
        if "dec_dense" in name and "kernel" in name:
            x = np.eye(*x.shape, dtype=np.float32)
        elif "dec_dense" in name:
            x = np.zeros_like(x)
        leaves.append(x)
    return leaves


def write_eval_scene(root, h=48, w=64):
    """labelme GT for frames 1 and 5 (one 'cup' box), three rendered feature levels in
    the render CLI's layout with the cup latent on level 2, the identity AE checkpoint
    and the prompt embeddings."""
    gt_dir = root / "label" / "scene"
    gt_dir.mkdir(parents=True)
    make_labelme_scene(gt_dir, h=h, w=w)
    for lvl in range(1, 4):
        d = root / "out" / f"scene_{lvl}" / "train" / "ours_None" / "renders_npy"
        d.mkdir(parents=True)
        for idx in range(5):
            fm = np.zeros((h, w, 3), np.float32)
            fm[...] = [0, 1, 0]
            if lvl == 2:
                fm[10:31, 10:31] = [1, 0, 0]
            np.save(d / f"{idx:05d}.npy", fm)
    leaves = identity_ae_leaves()
    ckpt = root / "ckpt" / "scene" / "best_ckpt.npz"
    ckpt.parent.mkdir(parents=True)
    np.savez(ckpt, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    d_cup, d_bg = np.eye(512, dtype=np.float32)[:2]
    np.savez(root / "text.npz", cup=d_cup, object=d_bg, things=d_bg, stuff=d_bg,
             texture=d_bg)
    return ["--dataset_name", "scene", "--feat_dir", str(root / "out"), "--ae_ckpt_dir",
            str(root / "ckpt"), "--json_folder", str(root / "label"),
            "--text_embeddings", str(root / "text.npz")]


def test_evaluate_and_eval_cli_match_jax(tmp_path):
    """The synthetic labelme scene through both eval CLIs (the port's on the CPU, with
    its visualization files): equal mIoU, chosen levels and localization accuracy."""
    args = write_eval_scene(tmp_path)
    theirs = jax_eval_main(args + ["--output_dir", str(tmp_path / "jax"), "--no_vis"])
    ours = torch_eval_main(args + ["--output_dir", str(tmp_path / "port"), "--device",
                                   "cpu"])
    assert ours["miou"] == theirs["miou"] > 0.5
    assert ours["localization_acc"] == theirs["localization_acc"] == 1.0
    assert ours["chosen_levels"] == theirs["chosen_levels"] == [1, 1]
    assert [f["idx"] for f in ours["frames"]] == [0, 4]
    for frame in ("00001", "00005"):
        base = tmp_path / "port" / "scene" / frame
        for lvl in range(3):
            assert (base / "heatmap" / f"cup_{lvl}.png").exists()
            assert (base / "composited" / f"cup_{lvl}.png").exists()
        assert (base / "chosen_cup.png").exists()
        assert (base / "localization" / "cup.png").exists()
    assert list((tmp_path / "port" / "scene").glob("*.log"))


def test_evaluate_defaults_to_the_card_and_matches_jax(tmp_path, monkeypatch):
    """`iou_loc.evaluate`, the library entry point, on the synthetic scene: with
    device="cpu" the same mIoU, levels and accuracy as JAX's `evaluate` on the same
    decoder and text; with no device and no card it raises instead of running on the
    CPU."""
    from langsplat_tpu.cli.autoencoder_cli import load_ae_checkpoint as jax_load
    from langsplat_tpu.evaluation.clip_text import PrecomputedTextEncoder as JaxText
    from langsplat_tpu_torch.cli.autoencoder_cli import load_ae_checkpoint
    from langsplat_tpu_torch.cli.eval_cli import make_decoder
    from langsplat_tpu_torch.evaluation.clip_text import PrecomputedTextEncoder

    write_eval_scene(tmp_path)
    feat_dirs = [str(tmp_path / "out" / f"scene_{lvl}" / "train" / "ours_None"
                     / "renders_npy") for lvl in range(1, 4)]
    json_folder = str(tmp_path / "label" / "scene")
    ckpt = str(tmp_path / "ckpt" / "scene" / "best_ckpt.npz")
    text = str(tmp_path / "text.npz")
    dims = ([256, 128, 64, 32, 3], [16, 32, 64, 128, 256, 256, 512])
    decode = make_decoder(load_ae_checkpoint(ckpt, *dims))
    ours = iou_loc.evaluate(feat_dirs, json_folder, decode, PrecomputedTextEncoder(text),
                            logger=lambda *_: None, device="cpu")
    jax_model, variables = jax_init(jax.random.key(0), *dims)
    variables = jax_load(ckpt, variables)
    theirs = jiou.evaluate(
        feat_dirs, json_folder,
        lambda z: jax_model.apply(variables, z, train=False, method="decode"),
        JaxText(text), logger=lambda *_: None)
    assert ours["miou"] == theirs["miou"] > 0.5
    assert ours["chosen_levels"] == theirs["chosen_levels"]
    assert ours["localization_acc"] == theirs["localization_acc"] == 1.0
    assert all(set(f) >= {"ious", "levels", "acc"} and "masks" not in f
               for f in ours["frames"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iou_loc.evaluate(feat_dirs, json_folder, decode, PrecomputedTextEncoder(text),
                         logger=lambda *_: None)


def test_turbo_table_and_pngs_match_jax(tmp_path):
    import matplotlib
    lut = matplotlib.colormaps["turbo"](np.linspace(0, 1, 256))[:, :3].astype(np.float32)
    np.testing.assert_array_equal(np.asarray(colormaps.TURBO, np.float32), lut)
    np.testing.assert_array_equal(colormaps._lut("turbo"), lut)
    rng = np.random.default_rng(8)
    relev = rng.uniform(0, 1, (24, 32)).astype(np.float32)
    rgb = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    mask = (relev > 0.5).astype(np.uint8)
    for mod, side in ((viz, "port"), (jviz, "jax")):
        mod.heatmap_png(relev, str(tmp_path / side / "heat.png"))
        mod.composited_png(relev, rgb, str(tmp_path / side / "comp.png"))
        mod.save_mask(mask, str(tmp_path / side / "mask.png"))
    for name in ("heat.png", "comp.png", "mask.png"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    hi = rng.normal(size=(8, 8, 16)).astype(np.float32)
    np.testing.assert_array_equal(colormaps.apply_colormap(hi), jcm.apply_colormap(hi))


def test_eval_cli_needs_a_card_and_text_embeddings(tmp_path, monkeypatch):
    """The prompt embeddings: --text_embeddings wins over --clip_model; without it the
    CLI builds the CLIP text encoder from --clip_model, else from DEFAULT_MODEL, on the
    CLI's device (the encoder is stubbed here, so nothing is loaded); and with no card
    and no --device it raises."""
    from langsplat_tpu_torch.evaluation import clip_text
    args = write_eval_scene(tmp_path)
    built = []

    class Recorded(clip_text.PrecomputedTextEncoder):
        def __init__(self, model_name_or_path, device=None):
            built.append((model_name_or_path, device))
            super().__init__(str(tmp_path / "text.npz"))
    monkeypatch.setattr(clip_text, "ClipTextEncoder", Recorded)
    out = ["--output_dir", str(tmp_path / "o"), "--no_vis", "--device", "cpu"]

    def scores(argv):
        r = torch_eval_main(argv + out)
        return r["miou"], r["chosen_levels"], r["localization_acc"]
    first = scores(args + ["--clip_model", "local/clip"])
    assert built == [] and first[0] > 0.5           # --text_embeddings won
    assert scores(args[:-2] + ["--clip_model", "local/clip"]) == first
    assert scores(args[:-2]) == first
    assert built == [("local/clip", torch.device("cpu")),
                     (clip_text.DEFAULT_MODEL, torch.device("cpu"))]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_eval_main(args + ["--output_dir", str(tmp_path / "o")])


def test_clis_run_without_opencv_and_matplotlib(tmp_path):
    """In a fresh interpreter whose import system refuses cv2, matplotlib and JAX: the
    AE train and test CLIs, then the eval CLI with --no_vis, on the CPU."""
    args = write_eval_scene(tmp_path)
    lf = tmp_path / "ae_scene" / "language_features"
    lf.mkdir(parents=True)
    rng = np.random.default_rng(9)
    np.save(lf / "a_f.npy", unit(rng, 30, 512))
    np.save(lf / "a_s.npy", rng.integers(-1, 30, (4, 5, 6)).astype(np.int32))
    ae = ["--dataset_path", str(tmp_path / "ae_scene"), "--dataset_name", "a",
          "--ckpt_root", str(tmp_path / "ae_ckpt"), "--device", "cpu"]
    code = f"""
import sys
REFUSED = ("cv2", "matplotlib", "jax", "flax", "optax", "langsplat_tpu")
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError("refused " + name)
        return None
sys.meta_path.insert(0, Refuse())
from langsplat_tpu_torch.cli import autoencoder_cli, eval_cli
autoencoder_cli.train_main({ae!r} + ["--num_epochs", "1", "--batch_size", "16"])
autoencoder_cli.test_main({ae!r})
r = eval_cli.main({args!r} + ["--output_dir", {str(tmp_path / "o")!r}, "--no_vis",
                              "--device", "cpu"])
assert r["localization_acc"] == 1.0, r
leaked = [m for m in sys.modules if m.split(".")[0] in REFUSED]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert (tmp_path / "ae_scene" / "language_features_dim3" / "a_f.npy").exists()
