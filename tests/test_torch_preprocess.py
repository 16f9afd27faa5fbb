"""PyTorch port, the language-feature preprocessing against the JAX package on the same
seeded inputs: mask NMS (ties and the top-3 fallback), masks_update, the stability
score, box NMS, the point grid and crop boxes, remove_small_regions (JAX: OpenCV),
the cv2-free INTER_LINEAR resize, tiles and seg maps, load_scene_images, the generator's
records in order, and the `_f.npy` / `_s.npy` files of `create`, with the JAX package's
toy predictor and with chip_smoke's phase-10 stand-ins; the device rule; and the
preprocessing CLI in an interpreter that refuses OpenCV, matplotlib and JAX."""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import jax
import pytest
import torch
from PIL import Image

import chip_smoke
from langsplat_tpu.preprocess import auto_mask as jam
from langsplat_tpu.preprocess import masks as jmasks
from langsplat_tpu.preprocess import pipeline as jpipe
from langsplat_tpu_torch.cli import preprocess_cli
from langsplat_tpu_torch.preprocess import auto_mask, masks, pipeline

from tests.test_preprocess import ToyPredictor, random_masks, reference_mask_nms

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CELLS = (4, 3)          # the stand-in scene's grid at test size


def standins(seed=0):
    return (chip_smoke.StandInPredictor(seed, "cpu"),
            chip_smoke.StandInEncoder(seed, "cpu"))


class Numpy:
    """A stand-in for the JAX side, which takes and gives numpy arrays."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        out = self.fn(*args)
        return tuple(t.numpy() for t in out) if isinstance(out, tuple) else out.numpy()


def f16_units(a, b):
    return chip_smoke.float16_units(np.asarray(a, np.float16), np.asarray(b, np.float16))


def same_records(jax_recs, port_recs):
    assert len(jax_recs) == len(port_recs)
    for a, b in zip(jax_recs, port_recs):
        np.testing.assert_array_equal(b["segmentation"].numpy(), a["segmentation"])
        np.testing.assert_array_equal(b["bbox"], a["bbox"])
        assert b["bbox"].dtype == np.float64
        assert b["predicted_iou"] == a["predicted_iou"]
        assert b["stability_score"] == a["stability_score"]
        assert b["point_coords"] == a["point_coords"]
        assert b["crop_box"] == a["crop_box"]


# ---------------------------------------------------------------------------
# masks.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "equal_scores", "below_score_thr", "nested"])
def test_mask_nms_keeps_what_jax_keeps(case):
    rng = np.random.default_rng(["random", "equal_scores", "below_score_thr",
                                 "nested"].index(case))
    m = random_masks(24, seed=int(rng.integers(100)))
    scores = rng.uniform(0.2, 1.0, 24)
    kw = dict(iou_thr=0.7, score_thr=0.3, inner_thr=0.2)
    if case == "equal_scores":                # ties: the stable order decides
        scores = np.round(scores, 1)
    elif case == "below_score_thr":           # no score passes: the top 3 are kept
        kw["score_thr"] = 2.0
    elif case == "nested":                    # squares inside squares
        m = np.zeros((6, 40, 40), bool)
        for i in range(6):
            m[i, 3 * i:40 - 3 * i, 3 * i:40 - 3 * i] = True
        scores = rng.uniform(0.2, 1.0, 6)
        kw["inner_thr"] = 0.5
    ours = masks.mask_nms(torch.from_numpy(m), scores, **kw)
    theirs = jmasks.mask_nms(m, scores, **kw)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(np.sort(ours), np.sort(reference_mask_nms(m, scores, **kw)))
    if case == "below_score_thr":
        assert len(ours) <= 3


def test_masks_update_equals_jax():
    rng = np.random.default_rng(3)
    levels = []
    for lvl in range(4):
        m = random_masks(16 + 8 * lvl, h=24, w=30, seed=lvl)
        levels.append([{"segmentation": s, "predicted_iou": float(rng.uniform(0.7, 1)),
                        "stability_score": float(rng.uniform(0.85, 1))} for s in m])
    levels[2] = []
    theirs = jmasks.masks_update(*levels, iou_thr=0.8, score_thr=0.7, inner_thr=0.5)
    ported = [[dict(r, segmentation=torch.from_numpy(r["segmentation"])) for r in lvl]
              for lvl in levels]
    ours = masks.masks_update(*ported, iou_thr=0.8, score_thr=0.7, inner_thr=0.5)
    for lvl, (a, b) in enumerate(zip(theirs, ours)):
        ids = {id(r): i for i, r in enumerate(levels[lvl])}
        pids = {id(r): i for i, r in enumerate(ported[lvl])}
        assert [ids[id(r)] for r in a] == [pids[id(r)] for r in b]
    assert [len(x) for x in ours][2] == 0 and all(len(x) > 0 for x in ours[:2])


@pytest.mark.parametrize("sizes", [
    [(37, 53, 224, 224), (224, 224, 224, 224), (448, 448, 224, 224), (300, 17, 224, 224)],
    [(1, 1, 224, 224), (5, 3, 224, 224), (113, 113, 224, 224), (449, 447, 224, 224)],
    [(1100, 90, 1080, 88), (96, 128, 48, 64), (20, 30, 61, 47), (7, 250, 3, 1)]])
def test_resize_linear_equals_cv2(sizes):
    """Bit for bit: upscales, downscales (2x included), odd sizes, a single pixel."""
    rng = np.random.default_rng(sum(sum(s) for s in sizes))
    for h, w, out_h, out_w in sizes:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        ours = masks.resize_linear(torch.from_numpy(img), out_w, out_h).numpy()
        np.testing.assert_array_equal(ours, cv2.resize(img, (out_w, out_h)))


def test_tiles_and_seg_map_equal_jax():
    """mask_to_segmap's tiles and seg map bit for bit against the JAX package (cv2's
    crop, pad and resize), on masks whose boxes are wide, tall, 1 px and the whole
    image; and the batched tiles equal to get_seg_img -> pad_img -> resize_linear."""
    rng = np.random.default_rng(4)
    h, w = 96, 128
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    recs = []
    for i in range(40):
        m = np.zeros((h, w), bool)
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        m[y0:y0 + rng.integers(1, 70), x0:x0 + rng.integers(1, 100)] = True
        if i == 0:
            m[:] = True
        elif i == 1:
            m[:] = False
            m[50, 60] = True
        m &= rng.random((h, w)) < 0.9
        m[y0, x0] = True
        recs.append({"segmentation": m, "bbox": jam.mask_to_bbox(m)})
    j_tiles, j_seg = jmasks.mask_to_segmap(recs, img)
    ported = [dict(r, segmentation=torch.from_numpy(r["segmentation"])) for r in recs]
    tiles, seg = masks.mask_to_segmap(ported, torch.from_numpy(img), chunk=16)
    assert tiles.dtype == torch.float32 and seg.dtype == torch.int32
    np.testing.assert_array_equal(tiles.numpy(), j_tiles)
    np.testing.assert_array_equal(seg.numpy(), j_seg)
    one = masks.resize_linear(masks.pad_img(masks.get_seg_img(ported[5], torch.from_numpy(
        img))), 224, 224)
    np.testing.assert_array_equal(one.permute(2, 0, 1).numpy() / np.float32(255.0),
                                  tiles[5].numpy())


@pytest.mark.parametrize("kind", ["png", "jpeg"])
def test_load_scene_images_equals_cv2(tmp_path, kind):
    """PIL's RGB equals cv2.imread + BGR2RGB, and the resize cv2's: images below and
    above 1080 rows (cut to 1080), and with --resolution. PNG bit for bit; JPEG at most
    one unit (the decoders may differ; here they agree everywhere)."""
    rng = np.random.default_rng(5)
    images = tmp_path / "images"
    images.mkdir()
    shapes = [(96, 128), (1100, 90), (48, 64)]
    ext = "png" if kind == "png" else "jpg"
    for i, (h, w) in enumerate(shapes):
        img = chip_smoke.paint_scene(i, w, h, (2, 2)) if i != 2 else rng.integers(
            0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(images / f"v{i}.{ext}")
    for resolution in (-1, 40):
        theirs, names = jpipe.load_scene_images(str(tmp_path), resolution)
        ours, our_names = pipeline.load_scene_images(str(tmp_path), resolution,
                                                     device="cpu")
        assert our_names == names
        for a, b in zip(ours, theirs):
            assert a.shape == b.shape and a.dtype == np.uint8
            diff = np.abs(a.astype(int) - b).max()
            print(kind, resolution, a.shape, "max abs diff", diff)
            assert diff == 0 if kind == "png" else diff <= 1
    cut = pipeline.load_scene_images(str(tmp_path), device="cpu")[0][1]
    assert cut.shape == (1080, 88, 3)


# ---------------------------------------------------------------------------
# auto_mask.py
# ---------------------------------------------------------------------------

def test_stability_box_nms_grid_and_crop_boxes_equal_jax():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2, (12, 20, 24)).astype(np.float32)
    logits[3] = -5.0                                    # empty at both thresholds
    ours = auto_mask.stability_score(torch.from_numpy(logits), 0.0, 1.0)
    assert ours.dtype == torch.float64
    np.testing.assert_array_equal(ours.numpy(), jam.stability_score(logits, 0.0, 1.0))
    for n in (1, 4, 32):
        np.testing.assert_array_equal(auto_mask.build_point_grid(n), jam.build_point_grid(n))
    for size, layers in (((60, 80), 1), ((768, 1024), 1), ((1080, 1440), 2), ((7, 5), 1)):
        assert auto_mask.generate_crop_boxes(size, layers, 512 / 1500) == \
            jam.generate_crop_boxes(size, layers, 512 / 1500)
    boxes = np.concatenate([rng.integers(0, 50, (60, 2)), rng.integers(1, 30, (60, 2))],
                           1).astype(np.float64)
    boxes[10] = boxes[11]                                # duplicate boxes
    for scores in (rng.uniform(0, 1, 60), np.round(rng.uniform(0, 1, 60), 1),
                   np.ones(60)):                         # ties: the stable order
        for thresh in (0.3, 0.7):
            ours = auto_mask.box_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                     thresh)
            np.testing.assert_array_equal(ours.numpy(), jam.box_nms(boxes, scores, thresh))
    segs = random_masks(10, h=20, w=24, seed=7)
    segs[4] = False
    np.testing.assert_array_equal(auto_mask.mask_to_bbox(torch.from_numpy(segs)).numpy(),
                                  np.stack([jam.mask_to_bbox(s) for s in segs]))
    edge = torch.from_numpy(np.stack([jam.mask_to_bbox(s) for s in segs]) + [30, 0, 0, 0])
    ours = auto_mask.is_box_near_crop_edge(edge, [25, 0, 60, 22], (40, 70))
    assert ours.tolist() == [jam.is_box_near_crop_edge(b, [25, 0, 60, 22], (40, 70))
                             for b in edge.numpy()]


@pytest.mark.parametrize("min_area", [20, 100])
def test_remove_small_regions_equals_cv2(min_area):
    """Against the JAX package's two cv2.connectedComponentsWithStats passes: random
    masks with islands and holes, boxes inside the image, on its border and spanning
    its width or height (where the whole background is labelled)."""
    rng = np.random.default_rng(min_area)
    changed = 0
    for t in range(300):
        h, w = (int(v) for v in rng.integers(4, 48, 2))
        if t % 3 == 0:
            m = rng.random((h, w)) < rng.uniform(0.05, 0.95)
        else:
            m = np.zeros((h, w), bool)
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            m[y0:y0 + rng.integers(1, h + 1), x0:x0 + rng.integers(1, w + 1)] = True
            m &= rng.random((h, w)) < 0.97                     # holes
            m |= rng.random((h, w)) < 0.01                     # islands
            if t % 3 == 2:
                m[:, 0] = m[:, -1] = True                      # the box spans the width
        if not m.any():
            continue
        theirs = jam.remove_small_regions(m, min_area)
        ours = auto_mask.remove_small_regions(m, min_area)
        np.testing.assert_array_equal(ours, theirs)
        changed += not np.array_equal(theirs, m)
    assert changed > 100


def generator_pair(kind, crop_n_layers, min_area, device="cpu"):
    if kind == "toy":
        image = np.zeros((64, 64, 3), np.uint8)
        port_pred = jax_pred = ToyPredictor()
        cfg = dict(points_per_side=4, pred_iou_thresh=0.7, stability_score_thresh=0.5,
                   points_per_batch=8)
    else:
        image = chip_smoke.paint_scene(11, 128, 96, CELLS)
        port_pred = standins()[0]
        jax_pred = Numpy(port_pred)
        cfg = dict(points_per_side=8)
    cfg.update(crop_n_layers=crop_n_layers, min_mask_region_area=min_area)
    return (image,
            jam.AutoMaskGenerator(jax_pred, jam.AutoMaskConfig(**cfg)),
            auto_mask.AutoMaskGenerator(port_pred, auto_mask.AutoMaskConfig(**cfg),
                                        device=device))


@pytest.mark.parametrize("kind", ["toy", "standin"])
@pytest.mark.parametrize("crop_n_layers", [0, 1])
@pytest.mark.parametrize("min_area", [0, 100])
def test_generator_records_equal_jax_in_order(kind, crop_n_layers, min_area):
    image, jgen, pgen = generator_pair(kind, crop_n_layers, min_area)
    theirs, ours = jgen.generate(image), pgen.generate(image)
    for a, b in zip(theirs, ours):
        same_records(a, b)
    assert len(ours[0]) > 0


def test_standin_scene_exercises_both_branches_of_remove_small_regions():
    """The phase-10 stand-in's masks lose islands and have holes filled."""
    image = chip_smoke.paint_scene(2, 128, 96, CELLS)
    pred = standins()[0]
    grid = jam.build_point_grid(8) * np.array([128, 96])
    mks, _, _ = pred(image, grid)
    islands = holes = 0
    for m in mks.reshape(-1, 96, 128).numpy():
        if not m.any():
            continue
        fixed = auto_mask.remove_small_regions(m, 100)
        islands += bool((m & ~fixed).any())
        holes += bool((fixed & ~m).any())
    assert islands > 0 and holes > 0


# ---------------------------------------------------------------------------
# pipeline.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["toy", "standin"])
def test_create_writes_the_files_jax_writes(tmp_path, kind):
    """`_s.npy` equal and `_f.npy` within one float16 unit of the JAX package's, from
    the same generator and image encoder (the JAX test's toy predictor and a seeded
    random encoder, or phase 10's stand-ins)."""
    if kind == "toy":
        image = np.full((48, 48, 3), 100, np.uint8)
        image[10:20, 5:40] = 7
        pred = ToyPredictor()
        cfg = dict(points_per_side=3, pred_iou_thresh=0.7, stability_score_thresh=0.5,
                   min_mask_region_area=0, points_per_batch=16)
        proj = np.random.default_rng(0).normal(size=(3, 512)).astype(np.float32)

        def encode(tiles):
            return np.asarray(tiles).mean(axis=(2, 3)) @ proj
        jenc, penc = encode, lambda t: torch.from_numpy(encode(t.numpy()))
        jpred = pred
    else:
        image = chip_smoke.paint_scene(12, 128, 96, CELLS)
        pred, penc = standins()
        jpred, jenc = Numpy(pred), Numpy(penc)
        cfg = dict(points_per_side=8, crop_n_layers=1)
    jgen = jam.AutoMaskGenerator(jpred, jam.AutoMaskConfig(**cfg))
    pgen = auto_mask.AutoMaskGenerator(pred, auto_mask.AutoMaskConfig(**cfg), device="cpu")
    jpipe.create([image], ["view0.png"], str(tmp_path / "jax"), jgen, jenc)
    pipeline.create([image], ["view0.png"], str(tmp_path / "port"), pgen, penc)
    s_j, s_p = (np.load(tmp_path / d / "view0_s.npy") for d in ("jax", "port"))
    f_j, f_p = (np.load(tmp_path / d / "view0_f.npy") for d in ("jax", "port"))
    assert s_p.dtype == s_j.dtype == np.int32 and f_p.dtype == np.float16
    np.testing.assert_array_equal(s_p, s_j)
    assert f_p.shape == f_j.shape and f16_units(f_p, f_j) <= 1
    assert s_p.max() == len(f_p) - 1


def test_embed_image_needs_default_masks():
    class Empty:
        device = torch.device("cpu")

        def generate(self, image):
            return [], [], [], []
    with pytest.raises(ValueError, match="default level"):
        pipeline.embed_image(np.zeros((8, 8, 3), np.uint8), Empty(), lambda t: t)


# ---------------------------------------------------------------------------
# the device rule and the CLI without OpenCV
# ---------------------------------------------------------------------------

def write_scene(root, views=2):
    (root / "images").mkdir(parents=True)
    for v in range(views):
        Image.fromarray(chip_smoke.paint_scene(20 + v, 128, 96, CELLS)).save(
            root / "images" / f"view_{v}.png")


def test_preprocessing_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    write_scene(tmp_path)
    pred, enc = standins()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: auto_mask.AutoMaskGenerator(pred),
                 lambda: pipeline.load_scene_images(str(tmp_path)),
                 lambda: preprocess_cli.main(["--dataset_path", str(tmp_path)], pred, enc)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "language_features").exists()
    preprocess_cli.main(["--dataset_path", str(tmp_path), "--device", "cpu",
                         "--points_per_side", "8"], pred, enc)
    assert sorted(os.listdir(tmp_path / "language_features")) == [
        "view_0_f.npy", "view_0_s.npy", "view_1_f.npy", "view_1_s.npy"]


def test_preprocess_cli_runs_without_opencv_and_matplotlib(tmp_path):
    """In a fresh interpreter whose import system refuses cv2, matplotlib and JAX: the
    preprocessing CLI with the stand-ins injected, on the CPU; its files equal those
    of the same CLI in this process."""
    write_scene(tmp_path / "a")
    write_scene(tmp_path / "b")
    pred, enc = standins()
    argv = ["--device", "cpu", "--points_per_side", "8"]
    preprocess_cli.main(["--dataset_path", str(tmp_path / "b")] + argv, pred, enc)
    code = f"""
import sys
REFUSED = ("cv2", "matplotlib", "jax", "flax", "optax", "langsplat_tpu")
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError("refused " + name)
        return None
sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(1)
import chip_smoke
from langsplat_tpu_torch.cli import preprocess_cli
preprocess_cli.main(["--dataset_path", {str(tmp_path / "a")!r}] + {argv!r},
                    chip_smoke.StandInPredictor(0, "cpu"), chip_smoke.StandInEncoder(0, "cpu"))
leaked = [m for m in sys.modules if m.split(".")[0] in REFUSED]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    for f in sorted(os.listdir(tmp_path / "b" / "language_features")):
        a = np.load(tmp_path / "a" / "language_features" / f)
        b = np.load(tmp_path / "b" / "language_features" / f)
        np.testing.assert_array_equal(a, b)
