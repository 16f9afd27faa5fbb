"""PyTorch port, the quality protocol (`langsplat_tpu_torch/quality/`): the OpenCV-free
polygon extraction against OpenCV point for point, the staged scene against the JAX
script's (`scripts/quality_run.py stage_scene`) at a tiny size, every stage of the
protocol at its smoke size on the CPU with the floors of `tests/test_quality_smoke.py`,
fault F3 (float16 feature maps in the eval) and finding F4 (the oracle mIoU follows the
autoencoder's training run, which rounding steers)."""

import filecmp
import functools
import importlib.util
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from langsplat_tpu.cli.eval_cli import main as jax_eval_main
from langsplat_tpu_torch.cli.eval_cli import main as torch_eval_main
from langsplat_tpu_torch.quality import contours
from langsplat_tpu_torch.quality import run as quality_run
from langsplat_tpu_torch.quality.scene import QualityParams, stage_scene

from tests.test_torch_eval import write_eval_scene

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@functools.cache
def jax_script():
    """`scripts/quality_run.py` as a module (it imports JAX inside its stages)."""
    spec = importlib.util.spec_from_file_location(
        "quality_run_jax", REPO / "scripts" / "quality_run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# contours: OpenCV 5.0 point for point
# ---------------------------------------------------------------------------

def disk(h, w, cy, cx, r, r_in=-1.0):
    yy, xx = np.mgrid[:h, :w]
    d = np.hypot(yy - cy, xx - cx)
    return (d <= r) & (d > r_in)


def hard_masks() -> dict[str, np.ndarray]:
    m = {}
    m["empty"] = np.zeros((9, 11), bool)
    m["full"] = np.ones((9, 11), bool)
    m["single_pixel"] = np.zeros((7, 7), bool)
    m["single_pixel"][3, 4] = True
    corners = np.zeros((8, 10), bool)
    corners[0, 0] = corners[0, 9] = corners[7, 0] = corners[7, 9] = True
    m["corner_pixels"] = corners
    edges = np.zeros((20, 24), bool)
    edges[0, 5:15] = edges[19, 3:9] = edges[4:12, 0] = edges[2:17, 23] = True
    m["lines_on_the_border"] = edges
    blob = np.zeros((30, 40), bool)
    blob[:12, :15] = True          # the top-left corner
    blob[20:, 30:] = True          # the bottom-right corner
    blob[10:22, 18:26] = True
    m["blobs_touching_the_border"] = blob
    lines = np.zeros((24, 24), bool)
    lines[3, 2:20] = True          # horizontal, one pixel wide
    lines[6:22, 5] = True          # vertical
    for i in range(12):            # diagonal
        lines[8 + i, 8 + i] = True
    m["one_pixel_lines"] = lines
    bridge = np.zeros((20, 20), bool)
    bridge[2:8, 2:8] = True
    bridge[8, 8] = bridge[9, 9] = True      # 8-connected diagonal bridge
    bridge[10:16, 10:16] = True
    bridge[2:6, 14:18] = True
    bridge[6, 13] = True                    # anti-diagonal touch
    m["diagonal_bridges"] = bridge
    m["ring_with_hole"] = disk(32, 32, 15.5, 15.5, 12, 6)
    nested = disk(40, 40, 20, 20, 17, 12) | disk(40, 40, 20, 20, 8, 4) | disk(40, 40, 20, 20, 2)
    m["nested_blobs"] = nested
    thin = np.zeros((16, 16), bool)
    thin[2, 2:14] = thin[13, 2:14] = thin[2:14, 2] = thin[2:14, 13] = True  # 1-px ring
    thin[6:10, 6:10] = True                 # a blob in its hole
    thin[5, 11] = True
    m["blob_in_a_one_pixel_ring"] = thin
    several = np.zeros((40, 50), bool)
    for cy, cx, r in ((8, 8, 6), (30, 12, 8), (10, 35, 4), (28, 38, 9), (20, 25, 2),
                      (36, 26, 3)):
        several |= disk(40, 50, cy, cx, r)
    m["several_blobs_top_three"] = several
    small = np.zeros((20, 20), bool)
    small[1:5, 1:5] = True         # area 9 < 16: cut
    small[8:13, 8:14] = True       # area 20: kept
    small[15:18, 2:9] = True       # area 12: cut
    m["area_below_sixteen"] = small
    flat = np.zeros((12, 30), bool)
    flat[3, 2:28] = True           # reduces to 2 points
    flat[6:8, 1:29] = True         # a 2-pixel strip
    flat[10, 5] = True
    m["polygons_of_fewer_than_three_points"] = flat
    return m


def random_mask(rng: np.random.Generator, kind: int) -> np.ndarray:
    h, w = (int(v) for v in rng.integers(3, 48, 2))
    if kind == 0:       # noise: many tiny, bridged and nested components
        return rng.random((h, w)) < rng.uniform(0.1, 0.9)
    if kind == 1:       # smooth blobs
        return ndimage.gaussian_filter(rng.random((h, w)), rng.uniform(0.5, 3)) > 0.5
    m = np.zeros((h, w), bool)     # rings and disks, xor-ed
    for _ in range(int(rng.integers(1, 6))):
        r = rng.uniform(0.5, 12)
        m ^= disk(h, w, rng.uniform(0, h), rng.uniform(0, w), r, rng.uniform(-1, r))
    return m


def assert_contours_equal_cv2(cv2, mask: np.ndarray) -> None:
    """findContours, contourArea, arcLength, approxPolyDP (at the protocol's epsilon
    and fixed ones) and mask_to_polygons, equal to OpenCV's."""
    theirs = [c[:, 0, :] for c in cv2.findContours(
        mask.astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]]
    ours = contours.find_contours(mask)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        assert contours.contour_area(a) == cv2.contourArea(b)
        assert contours.arc_length(a) == cv2.arcLength(b, True)
        for eps in (0.004 * cv2.arcLength(b, True), 0.5, 1.0, 2.5):
            np.testing.assert_array_equal(contours.approx_poly_dp(a, eps),
                                          cv2.approxPolyDP(b, eps, True)[:, 0, :])
    assert contours.mask_to_polygons(mask.astype(np.uint8)) == \
        jax_script().mask_to_polygons(mask.astype(np.uint8))


@pytest.mark.parametrize("name", sorted(hard_masks()))
def test_contours_equal_opencv_on_hard_masks(name):
    cv2 = pytest.importorskip("cv2")
    assert_contours_equal_cv2(cv2, hard_masks()[name])


def test_hard_masks_exercise_each_rule():
    """The hard cases reach what they are named for: the cut below area 16, polygons
    of fewer than 3 points, the top-three choice, and nested blobs left out."""
    masks = hard_masks()
    small = contours.find_contours(masks["area_below_sixteen"])
    assert sorted(contours.contour_area(c) for c in small)[:2] == [9.0, 12.0]
    assert len(contours.mask_to_polygons(masks["area_below_sixteen"])) == 1
    assert len(contours.mask_to_polygons(masks["polygons_of_fewer_than_three_points"])) == 1
    assert len(contours.find_contours(masks["several_blobs_top_three"])) == 6
    assert len(contours.mask_to_polygons(masks["several_blobs_top_three"])) == 3
    assert len(contours.find_contours(masks["nested_blobs"])) == 1
    assert len(contours.find_contours(masks["ring_with_hole"])) == 1


@pytest.mark.parametrize("seed", range(6))
def test_contours_equal_opencv_on_random_masks(seed):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(100 + seed)
    for k in range(150):
        assert_contours_equal_cv2(cv2, random_mask(rng, k % 3))


def test_contours_equal_opencv_on_protocol_sized_masks():
    """Smooth masks at the protocol's 960x720 and at smaller sizes."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(7)
    for h, w in ((720, 960), (150, 200), (96, 128)):
        field = ndimage.gaussian_filter(rng.random((h, w)), h / 40)
        mask = field > np.quantile(field, 0.6)
        assert_contours_equal_cv2(cv2, mask)


# ---------------------------------------------------------------------------
# the staged scene against the JAX script's
# ---------------------------------------------------------------------------

TINY = dict(width=64, height=48, focal=60.0, n_cams=3, n_objects=1, floor_pts=300,
            obj_pts=150, init_pts=100, eval_frames=2)
PNG_LEVELS = 1          # GT images: uint8 levels
PNG_SHARE = 0.01        # share of image values that may differ by that level
MASK_SHARE = 0.01       # share of mask / segment-map pixels that may differ (near ties)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The scene staged by the JAX script (its P set to TINY, interpret=True: the JAX
    tiled backend on the CPU) and by the port on the CPU."""
    root = tmp_path_factory.mktemp("staged")
    script = jax_script()
    for key, value in TINY.items():
        setattr(script.P, key, value)
    script.P.interpret = True
    script.stage_scene(str(root / "jax"))
    stage_scene(str(root / "port"), QualityParams(**TINY), "cpu")
    return root / "jax", root / "port"


def test_staged_files_byte_equal(staged):
    jax_ws, port_ws = staged
    sparse = Path("scene", "sparse", "0")
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert filecmp.cmp(jax_ws / sparse / name, port_ws / sparse / name, shallow=False)
    features = sorted((jax_ws / "scene" / "language_features").glob("*_f.npy"))
    assert len(features) == TINY["n_cams"]
    for path in features:
        assert filecmp.cmp(path, port_ws / path.relative_to(jax_ws), shallow=False)
    assert filecmp.cmp(jax_ws / "text_embeddings.npz", port_ws / "text_embeddings.npz",
                       shallow=False)


def test_staged_images_and_masks_agree(staged):
    jax_ws, port_ws = staged
    for path in sorted((jax_ws / "scene" / "images").glob("*.png")):
        a = np.asarray(Image.open(path)).astype(int)
        b = np.asarray(Image.open(port_ws / path.relative_to(jax_ws))).astype(int)
        assert np.abs(a - b).max() <= PNG_LEVELS
        assert (a != b).mean() <= PNG_SHARE
    maps = sorted((jax_ws / "gt_masks").glob("*.npy")) + sorted(
        (jax_ws / "scene" / "language_features").glob("*_s.npy"))
    assert len(maps) == 3 * TINY["n_cams"]
    for path in maps:
        a, b = np.load(path), np.load(port_ws / path.relative_to(jax_ws))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert (a != b).mean() <= MASK_SHARE


def test_staged_labelme_polygons_agree(staged):
    """Equal categories; equal polygons wherever the masks they come from are equal."""
    jax_ws, port_ws = staged
    label = Path("label", "synthroom")
    files = sorted((jax_ws / label).glob("*.json"))
    assert len(files) == TINY["eval_frames"]
    for path in files:
        a = json.loads(path.read_text())
        b = json.loads((port_ws / label / path.name).read_text())
        assert [o["category"] for o in a["objects"]] == [o["category"] for o in b["objects"]]
        assert a["info"] == b["info"]
        tp = int(path.stem[6:11]) - 1
        name = f"frame_{QualityParams(**TINY).train_positions()[tp] + 1:05d}"
        same = all(np.array_equal(np.load(jax_ws / "gt_masks" / f"{name}{s}.npy"),
                                  np.load(port_ws / "gt_masks" / f"{name}{s}.npy"))
                   for s in ("", "_part"))
        if same:
            assert a["objects"] == b["objects"]


# ---------------------------------------------------------------------------
# every stage at the smoke size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """`python -m langsplat_tpu_torch.quality.run --smoke --device cpu`, every stage:
    (its workspace, its report)."""
    ws = tmp_path_factory.mktemp("quality") / "qws"
    results = quality_run.main(["--smoke", "--device", "cpu", "--ws", str(ws)])
    return Path(str(ws) + "_smoke"), results["report"]


def test_smoke_protocol_every_stage_on_the_cpu(smoke):
    """The smoke run's report has the keys of QUALITY_r04.json and clears the floors of
    tests/test_quality_smoke.py."""
    ws, rep = smoke
    with open(REPO / "QUALITY_r04.json") as fh:
        reference = json.load(fh)
    assert set(reference) <= set(rep)
    for key in ("scene", "phase_a", "phase_b"):
        assert set(reference[key]) <= set(rep[key])
    assert set(reference["eval"]) <= set(rep["eval"])
    assert set(reference["eval_oracle"]) <= set(rep["eval_oracle"])
    assert json.loads((ws / "QUALITY_torch.json").read_text()) == rep

    curve = rep["phase_a"]["psnr_curve"]
    assert len(curve) >= 2
    assert curve[-1]["psnr"] > curve[0]["psnr"]
    assert rep["phase_a"]["final_test_psnr_mean"] > 10.0
    feat = rep["phase_b"]["final_test_feature_l1"]
    assert set(feat) == {"1", "2", "3"}
    assert all(0.0 < v < 1.0 for v in feat.values())
    assert rep["eval_oracle"]["miou"] > 0.5
    assert rep["eval"]["miou"] > 0.2
    # the record beside the figures: every stage timed, the launches of each training
    # stage counted (0 on the CPU: the plain versions run), the device named
    assert set(rep["stage_seconds"]) >= set(quality_run.STAGES) - {"report"}
    for st in ("phaseA", "phaseB", "render"):
        assert set(rep["launches"][st]) == {"blend_fwd", "blend_bwd", "segsum",
                                            "preprocess_fwd", "preprocess_bwd",
                                            "ssim_fwd", "ssim_bwd", "bin_count",
                                            "bin_rank", "bin_emit", "bin_sort",
                                            "bin_ranges", "adam_update"}
    assert set(rep["launches"]["phaseB_levels"]) == {"1", "2", "3"}
    assert rep["device"] == "cpu"


def test_the_protocol_needs_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quality_run.main(["--smoke", "--ws", str(tmp_path / "ws"), "--stages", "scene"])
    assert not (tmp_path / "ws_smoke" / "scene").exists()


def test_f4_the_oracle_follows_the_autoencoders_init(smoke, tmp_path, monkeypatch):
    """F4: the oracle mIoU is a figure of the autoencoder's training run, which float
    rounding steers, not of the scene alone. On the smoke run's scene: the JAX script's
    oracle and the port's of one and the same checkpoint (the JAX CLI's) agree; one
    epoch from the JAX CLI's init, the port's AE has the JAX CLI's codes to 1e-4; the
    port's full AE run from that init scores the JAX oracle within 0.05. The port's
    own-init oracle is printed beside it, as a reading: one draw's distance from
    another is not a condition."""
    from langsplat_tpu.cli.autoencoder_cli import train_main as jax_train_main
    from langsplat_tpu_torch.quality import ae_compare

    src, rep = smoke
    params = QualityParams.smoke()
    ws = tmp_path / "ws"
    for part in ("scene", "label"):
        shutil.copytree(src / part, ws / part)
    shutil.copy(src / "text_embeddings.npz", ws)
    run = quality_run.Run(str(ws), params, "cpu")

    def jax_ae(name, *flags):
        jax_train_main(["--dataset_path", run.scene_dir, "--dataset_name", params.scene,
                        "--ckpt_root", str(tmp_path / name), *flags])
        return str(tmp_path / name / params.scene / "best_ckpt.npz")

    init = jax_ae("init", "--num_epochs", "0")
    after_one = jax_ae("e1", "--num_epochs", "1", "--eval_from_frac", "1.0")
    theirs = jax_ae("best", "--num_epochs", str(params.ae_epochs))

    # one checkpoint, both packages' oracles
    script = jax_script()
    for key in ("scene", "n_cams", "width", "height"):
        monkeypatch.setattr(script.P, key, getattr(params, key))
    (ws / "ckpt" / params.scene).mkdir(parents=True)
    shutil.copy(theirs, ws / "ckpt" / params.scene / "best_ckpt.npz")
    script.stage_oracle(str(ws))
    jax_oracle = json.loads((ws / "eval_oracle.json").read_text())
    shared = ae_compare.oracle_of(run, theirs, "shared")
    assert abs(shared["miou"] - jax_oracle["miou"]) <= 1e-6, (shared, jax_oracle)
    assert shared["localization_acc"] == jax_oracle["localization_acc"]

    # the same init and batches: equal codes after an epoch, the JAX oracle after all
    rows = ae_compare.scene_rows(run)
    ours_one = ae_compare.train_port(run, "e1", 1,
                                     ["--eval_from_frac", "1.0", "--init_ckpt", init])
    drift = np.abs(ae_compare.codes(ours_one, rows) - ae_compare.codes(after_one, rows))
    assert drift.max() <= 1e-4, drift.max()
    ours_from_jax_init = ae_compare.oracle_of(
        run, ae_compare.train_port(run, "from_jax_init", params.ae_epochs,
                                   ["--init_ckpt", init]), "from_jax_init")["miou"]
    assert abs(ours_from_jax_init - jax_oracle["miou"]) <= 0.05, (ours_from_jax_init,
                                                                  jax_oracle)
    print(f"oracle mIoU: JAX CLI's AE {jax_oracle['miou']:.4f}, the port's from JAX's "
          f"init {ours_from_jax_init:.4f}, the port's own init "
          f"{rep['eval_oracle']['miou']:.4f}")


def test_f4_autoencoder_steps_agree_then_drift_on_a_published_shape_table():
    """F4's mechanism, on a table of the protocol's shape (a hierarchical table of 7
    object, 14 part and 28 subpart embeddings, each frame's rows, 40 frames: 1,960
    rows): from the JAX CLI's init and on the CLI's batches, the port's AE step equals
    optax's to rounding after one step (seen: 1.1e-6 on the published table), and the
    two then part by Adam's scaling of rounding noise. The drift is printed, not held:
    it is a reading of rounding, not a condition."""
    import jax
    import jax.numpy as jnp
    import optax

    from langsplat_tpu.models.autoencoder import ae_loss as jax_ae_loss
    from langsplat_tpu.models.autoencoder import init_autoencoder as jax_init
    from langsplat_tpu_torch.cli.autoencoder_cli import TrainStep
    from langsplat_tpu_torch.models.autoencoder import from_jax_leaves, to_jax_leaves

    def unit(x):
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    rng = np.random.default_rng(7)
    objects = unit(rng.normal(size=(7, 512)))
    parts = unit(objects.repeat(2, 0) + 0.08 * rng.normal(size=(14, 512)))
    subparts = unit(parts.repeat(2, 0) + 0.06 * rng.normal(size=(28, 512)))
    data = np.tile(np.concatenate([objects, parts, subparts]), (40, 1))
    n, bs = data.shape[0], 64
    steps = -(-n // bs)

    model, variables = jax_init(jax.random.split(jax.random.key(0))[1],
                                quality_run.AE_ENCODER, quality_run.AE_DECODER)
    port = from_jax_leaves(jax.tree.leaves(variables), quality_run.AE_ENCODER,
                           quality_run.AE_DECODER)
    tx = optax.adam(7e-4)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)

    @jax.jit
    def step(params, stats, opt_state, batch):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, batch,
                                   train=True, mutable=["batch_stats"])
            return jax_ae_loss(out, batch), upd["batch_stats"]
        (loss, new_stats), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        u, new_opt = tx.update(g, opt_state, params)
        return optax.apply_updates(params, u), new_stats, new_opt, loss

    tstep = TrainStep(port, 7e-4)
    perm = np.random.default_rng(0).permutation(n)
    order = np.concatenate([perm, perm[:steps * bs - n]])
    drift = []
    for i in range(steps):
        batch = data[order[i * bs:(i + 1) * bs]]
        params, stats, opt_state, _ = step(params, stats, opt_state, jnp.asarray(batch))
        tstep(torch.from_numpy(batch))
        theirs = jax.tree.leaves({"params": params, "batch_stats": stats})
        drift.append(max(float(np.abs(a - np.asarray(b)).max())
                         for a, b in zip(to_jax_leaves(port), theirs)))
    assert drift[0] <= 1e-5, drift[0]
    print("largest leaf difference after steps 1, 5, 10, 20, 31: "
          + ", ".join(f"{drift[k - 1]:.2g}" for k in (1, 5, 10, 20, steps)))


# ---------------------------------------------------------------------------
# F3: float16 feature maps
# ---------------------------------------------------------------------------

def test_float16_feature_maps_evaluate_as_jax(tmp_path):
    """F3: the eval on float16 feature maps (as the oracle stage writes them). The JAX
    decoder promotes them to float32 (flax's Dense); the port decoded them as float16
    against float32 weights and raised. Now both agree, and equal the float32 maps'."""
    args = write_eval_scene(tmp_path)
    for path in (tmp_path / "out").rglob("*.npy"):
        np.save(path, np.load(path).astype(np.float16))
    theirs = jax_eval_main(args + ["--output_dir", str(tmp_path / "jax"), "--no_vis"])
    ours = torch_eval_main(args + ["--output_dir", str(tmp_path / "port"), "--no_vis",
                                   "--device", "cpu"])
    assert ours["miou"] == theirs["miou"] > 0.5
    assert ours["chosen_levels"] == theirs["chosen_levels"] == [1, 1]
    assert ours["localization_acc"] == theirs["localization_acc"] == 1.0
