"""The quality protocol's run parameters and its synthetic scene with known semantics,
staged from a seed (`scripts/quality_run.py stage_scene` and its helpers, on the port).

The scene is a COLMAP tree: a textured floor and K textured spheres whose ground-truth
Gaussians (sh_degree 0) are rendered through `train/loop.py render_full` into the
training images; an SfM-like init of noisy GT points; per view, the object, part and
subpart segmentations from indicator-feature renders (3 channels a pass, argmaxed), the
`_s.npy` segment maps and `_f.npy` tables of a hierarchical 512-d embedding ("CLIP")
table; labelme JSONs of a few train-split views; and the prompt embeddings
(`text_embeddings.npz`). Every random draw comes from `np.random.default_rng(7)` in the
JAX script's order, the per-view table noise inside the render loop included, so both
packages stage the same scene.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import time

import numpy as np
import torch

SEED = 7
SCENE_BUDGET_FACTOR = 16    # the GT renders' instance-budget cap
PALETTE = np.array([
    [0.85, 0.25, 0.20], [0.20, 0.55, 0.85], [0.95, 0.80, 0.25],
    [0.30, 0.75, 0.35], [0.70, 0.35, 0.80], [0.90, 0.55, 0.20],
], np.float32)


@dataclasses.dataclass(frozen=True)
class QualityParams:
    """The protocol's run parameters: the published scene and the reference's training
    protocol (30k phase-A iterations, densification until 15k, opacity resets every
    3k), 5k phase-B iterations a level and a 400-epoch autoencoder. `smoke()` is the
    tiny CPU run of every stage."""
    scene: str = "synthroom"
    width: int = 960
    height: int = 720
    focal: float = 900.0
    n_cams: int = 40
    n_objects: int = 6
    floor_pts: int = 40_000
    obj_pts: int = 12_000
    init_pts: int = 28_000
    embed_dim: int = 512
    iters_a: int = 30_000
    densify_from: int = 500
    densification_interval: int = 100
    densify_until: int = 15_000
    opacity_reset_interval: int = 3_000
    densify_grad_threshold: float = 2e-4
    test_every: int = 2_500
    iters_b: int = 5_000
    ae_epochs: int = 400
    eval_frames: int = 5            # annotated train views
    # the training and render CLIs' instance-budget cap (960x720 tile rects are ~2x the
    # 640x480 ones a Gaussian)
    budget_factor: int = 14

    @classmethod
    def smoke(cls) -> "QualityParams":
        """Every stage at a tiny size for the CPU: 2 objects, 96x72, a few hundred
        Gaussians over many tiles (hence the larger budget factor), tens of iterations."""
        return cls(width=96, height=72, focal=90.0, n_cams=10, n_objects=2,
                   floor_pts=300, obj_pts=120, init_pts=200, iters_a=60,
                   densify_from=10, densification_interval=10, densify_until=40,
                   opacity_reset_interval=30, test_every=30, iters_b=30, ae_epochs=300,
                   eval_frames=2, budget_factor=32)

    @property
    def gaussians_gt(self) -> int:
        return self.floor_pts + self.n_objects * self.obj_pts

    def train_positions(self) -> list[int]:
        """Reader-order indices of the train split (llffhold 8)."""
        return [i for i in range(self.n_cams) if i % 8 != 0]


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion from a rotation matrix."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def look_at(pos, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """World->cam rotation in COLMAP convention (x right, y down, z forward)."""
    f = np.asarray(target, np.float64) - np.asarray(pos, np.float64)
    f /= np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r /= np.linalg.norm(r)
    d = np.cross(f, r)
    return np.stack([r, d, f])


def build_gt_geometry(p: QualityParams, rng: np.random.Generator):
    """-> (means [N,3], colors [N,3], scales [N], labels [N], centers [K,3]): the floor
    (label 0) and K striped spheres on a ring (labels 1..K)."""
    k = p.n_objects
    ang = np.linspace(0, 2 * np.pi, k, endpoint=False) + 0.3
    rad = rng.uniform(0.9, 1.5, k)
    r_obj = rng.uniform(0.28, 0.42, k)
    centers = np.stack([rad * np.cos(ang), rad * np.sin(ang), r_obj + 0.02], axis=1)

    means, colors, scales, labels = [], [], [], []
    # floor: 6x6 plane at z=0 with a two-tone check and a colour wash
    n = p.floor_pts
    xy = rng.uniform(-3, 3, (n, 2))
    z = np.zeros((n, 1))
    check = ((np.floor(xy[:, 0] / 0.5) + np.floor(xy[:, 1] / 0.5)) % 2)
    base = np.where(check[:, None] > 0, 0.62, 0.30)
    wash = 0.08 * np.stack([np.sin(2.1 * xy[:, 0]), np.sin(1.7 * xy[:, 1]),
                            np.cos(1.3 * (xy[:, 0] + xy[:, 1]))], axis=1)
    means.append(np.concatenate([xy, z], axis=1))
    colors.append(np.clip(base + wash, 0.02, 0.98))
    scales.append(np.full(n, 6.0 / np.sqrt(n) * 0.8))
    labels.append(np.zeros(n, np.int32))

    for i in range(k):
        n = p.obj_pts
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        pts = centers[i] + r_obj[i] * v
        stripes = 0.20 * np.sin(9.0 * v[:, 2:3] + i) * np.array([[1, -0.6, 0.3]])
        col = np.clip(PALETTE[i % len(PALETTE)] + stripes
                      + rng.normal(0, 0.02, (n, 3)), 0.02, 0.98)
        means.append(pts)
        colors.append(col)
        scales.append(np.full(n, 2.2 * r_obj[i] / np.sqrt(n) * 2.2))
        labels.append(np.full(n, i + 1, np.int32))

    return (np.concatenate(means).astype(np.float32),
            np.concatenate(colors).astype(np.float32),
            np.concatenate(scales).astype(np.float32),
            np.concatenate(labels), centers)


def make_cameras(p: QualityParams):
    """Orbit poses: (qvecs, tvecs) world->cam, COLMAP convention."""
    target = np.array([0.0, 0.0, 0.25])
    qvecs, tvecs = [], []
    for i in range(p.n_cams):
        a = 2 * np.pi * i / p.n_cams
        elev = np.deg2rad(18 + 14 * np.sin(3.1 * a))
        radius = 4.1 + 0.3 * np.cos(2.3 * a)
        pos = target + radius * np.array(
            [np.cos(a) * np.cos(elev), np.sin(a) * np.cos(elev), np.sin(elev)])
        R = look_at(pos, target)
        qvecs.append(rotmat_to_qvec(R))
        tvecs.append(-R @ pos)
    return np.asarray(qvecs), np.asarray(tvecs)


def write_colmap(p: QualityParams, root: str, qvecs, tvecs, pts, rgb8) -> None:
    """sparse/0/{cameras,images,points3D}.bin: one PINHOLE camera, the views, the
    SfM points (each seen once)."""
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    w, h, f = p.width, p.height, p.focal
    with open(os.path.join(sparse, "cameras.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, 1, w, h))            # PINHOLE
        fh.write(struct.pack("<dddd", f, f, w / 2.0, h / 2.0))
    with open(os.path.join(sparse, "images.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(qvecs)))
        for i, (q, t) in enumerate(zip(qvecs, tvecs)):
            fh.write(struct.pack("<idddddddi", i + 1, *q, *t, 1))
            fh.write(f"frame_{i + 1:05d}.png".encode() + b"\x00")
            fh.write(struct.pack("<Q", 2))
            fh.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)
    with open(os.path.join(sparse, "points3D.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(pts)))
        for i in range(len(pts)):
            fh.write(struct.pack("<QdddBBBd", i + 1, *pts[i], *rgb8[i], 0.5))
            fh.write(struct.pack("<Q", 1))
            fh.write(struct.pack("<ii", 1, 0))


def gt_field(means, colors, scales, device, opacity: float = 0.92):
    """The GT GaussianField: isotropic, sh_degree 0 (an empty `features_rest`)."""
    from langsplat_tpu_torch.core import sh as sh_lib
    from langsplat_tpu_torch.core import transforms
    from langsplat_tpu_torch.models.gaussian_field import GaussianField

    n = means.shape[0]
    rotation = torch.zeros((n, 4), dtype=torch.float32)
    rotation[:, 0] = 1.0
    field = GaussianField(
        xyz=torch.as_tensor(means),
        features_dc=sh_lib.rgb_to_sh(torch.as_tensor(colors))[:, None, :],
        features_rest=torch.zeros((n, 0, 3), dtype=torch.float32),
        scaling=torch.log(torch.as_tensor(scales))[:, None].repeat(1, 3),
        rotation=rotation,
        opacity=transforms.inverse_sigmoid(torch.full((n, 1), opacity,
                                                      dtype=torch.float32)),
        language_feature=None,
        alive=torch.ones((n,), dtype=torch.bool))
    return field.to(device)


def _weights(field, cam, pipe, ids: np.ndarray, n_ids: int, device) -> np.ndarray:
    """[n_ids, H, W]: each id's blend weight per pixel, from indicator-feature renders
    of 3 ids a pass."""
    from langsplat_tpu_torch.train.loop import render_full

    out = []
    for first in range(0, n_ids, 3):
        ind = np.zeros((len(ids), 3), np.float32)
        for c in range(3):
            if first + c < n_ids:
                ind[:, c] = ids == first + c
        f2 = dataclasses.replace(field, language_feature=torch.as_tensor(ind).to(device))
        o2 = render_full(f2, cam, pipe, 0, True, [0.0, 0.0, 0.0], device=device)
        out.append(o2["language_feature_image"].cpu().numpy())
    return np.concatenate(out, axis=0)[:n_ids]


def stage_scene(ws: str, p: QualityParams, device) -> dict:
    """Build the GT scene under `ws`: the COLMAP tree `scene/` with its GT renders and
    language features, the eval GT (`gt_masks/`, `label/<scene>/`) and
    `text_embeddings.npz`. Renders on `device`; returns counts and seconds."""
    from PIL import Image

    from langsplat_tpu_torch.config import PipelineConfig
    from langsplat_tpu_torch.data.cameras import load_camera
    from langsplat_tpu_torch.data.dataset import read_colmap_scene
    from langsplat_tpu_torch.evaluation.relevancy import NEGATIVE_PROMPTS
    from langsplat_tpu_torch.quality.contours import mask_to_polygons
    from langsplat_tpu_torch.train.loop import render_full

    device = torch.device(device)
    rng = np.random.default_rng(SEED)
    root = os.path.join(ws, "scene")
    os.makedirs(os.path.join(root, "images"), exist_ok=True)

    means, colors, scales, labels, centers = build_gt_geometry(p, rng)
    qvecs, tvecs = make_cameras(p)

    # SfM-like init: subsampled GT points + noise
    sel = rng.choice(len(means), size=min(p.init_pts, len(means)), replace=False)
    init_pts = means[sel] + rng.normal(0, 0.02, (len(sel), 3)).astype(np.float32)
    init_rgb = np.clip(colors[sel] + rng.normal(0, 0.05, (len(sel), 3)), 0, 1)
    write_colmap(p, root, qvecs, tvecs, init_pts, (init_rgb * 255).astype(np.uint8))

    # placeholder images so the reader can load, then render GT and overwrite
    ph = np.zeros((p.height, p.width, 3), np.uint8)
    for i in range(p.n_cams):
        Image.fromarray(ph).save(os.path.join(root, "images", f"frame_{i + 1:05d}.png"))

    info = read_colmap_scene(root, "images", eval_split=False)
    cams = [load_camera(ci, 1.0, 1, uid=i) for i, ci in enumerate(info.train_cameras)]
    cams.sort(key=lambda c: c.image_name)

    pipe = PipelineConfig(budget_factor=SCENE_BUDGET_FACTOR)
    field = gt_field(means, colors, scales, device)

    n_lab = p.n_objects + 1
    os.makedirs(os.path.join(ws, "gt_masks"), exist_ok=True)
    lf_dir = os.path.join(root, "language_features")
    os.makedirs(lf_dir, exist_ok=True)

    # hierarchical 512-d embedding table: objects, 2 parts per object (z halves), 2
    # subparts per part (x halves); a child correlates with its parent (cos ~0.5/0.6)
    # yet every level is distinct, so the eval's best-of-levels choice must pick the
    # part level for part prompts and the object level for whole objects
    embeds = rng.normal(size=(n_lab, p.embed_dim)).astype(np.float32)
    embeds /= np.linalg.norm(embeds, axis=1, keepdims=True)
    part_embeds = []
    for k in range(n_lab):
        for _ in range(2):
            e = embeds[k] + 0.08 * rng.normal(size=p.embed_dim).astype(np.float32)
            part_embeds.append(e / np.linalg.norm(e))
    part_embeds = np.asarray(part_embeds, np.float32)
    sub_embeds = []
    for pid in range(2 * n_lab):
        for _ in range(2):
            e = part_embeds[pid] + 0.06 * rng.normal(size=p.embed_dim).astype(np.float32)
            sub_embeds.append(e / np.linalg.norm(e))
    sub_embeds = np.asarray(sub_embeds, np.float32)
    # part id per Gaussian: 2 * label + (above the object's centre z); subpart id:
    # 2 * part + (right of its centre x)
    zc = np.where(labels > 0, centers[np.maximum(labels - 1, 0), 2], 0.0)
    xc = np.where(labels > 0, centers[np.maximum(labels - 1, 0), 0], 0.0)
    part_of_gauss = 2 * labels + (means[:, 2] > zc).astype(np.int32)
    sub_of_gauss = 2 * part_of_gauss + (means[:, 0] > xc).astype(np.int32)

    t0 = time.perf_counter()
    for i, cam in enumerate(cams):
        out = render_full(field, cam, pipe, 0, False, [0.0, 0.0, 0.0], device=device)
        img = out["render"].cpu().numpy().transpose(1, 2, 0)
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"{cam.image_name}.png"))

        wts = _weights(field, cam, pipe, labels, n_lab, device)
        total = wts.sum(axis=0)
        seg_obj = np.where(total > 0.5, np.argmax(wts, axis=0), -1)
        pw = _weights(field, cam, pipe, part_of_gauss, 2 * n_lab, device)
        seg_part = np.where(total > 0.5, np.argmax(pw, axis=0), -1)
        sw = _weights(field, cam, pipe, sub_of_gauss, 4 * n_lab, device)
        seg_sub = np.where(total > 0.5, np.argmax(sw, axis=0), -1)

        np.save(os.path.join(ws, "gt_masks", f"{cam.image_name}.npy"), seg_obj)
        np.save(os.path.join(ws, "gt_masks", f"{cam.image_name}_part.npy"), seg_part)

        # seg levels [default, s, m, l]: three distinct granularities (1 = subparts,
        # 2 = parts, 3 = objects); table rows [object | part | subpart] embeddings with
        # small per-view noise (the per-crop variation of the preprocessing)
        seg4 = np.stack([seg_obj,
                         np.where(seg_sub >= 0, seg_sub + 3 * n_lab, -1),
                         np.where(seg_part >= 0, seg_part + n_lab, -1),
                         seg_obj]).astype(np.int32)
        table = np.concatenate([embeds, part_embeds, sub_embeds], axis=0)
        table = table + 0.01 * rng.normal(size=table.shape).astype(np.float32)
        table /= np.linalg.norm(table, axis=1, keepdims=True)
        np.save(os.path.join(lf_dir, f"{cam.image_name}_s.npy"), seg4)
        np.save(os.path.join(lf_dir, f"{cam.image_name}_f.npy"), table.astype(np.float16))
        if i % 8 == 0:
            print(f"  GT render {i + 1}/{len(cams)} ({time.perf_counter() - t0:.0f}s)",
                  flush=True)

    # eval GT: labelme JSONs of a few train-split views (llffhold 8)
    train_positions = p.train_positions()
    picks = np.linspace(0, len(train_positions) - 1, p.eval_frames).astype(int)
    json_dir = os.path.join(ws, "label", p.scene)
    os.makedirs(json_dir, exist_ok=True)
    cat_names = ["floor"] + [f"sphere_{i}" for i in range(p.n_objects)]
    # part prompts for the first two spheres: their GT is at the part level, so the
    # best-of-levels choice must pick it for them and the object level for the rest
    part_cats = {}
    for i in range(min(2, p.n_objects)):
        for half, hn in ((0, "bottom"), (1, "top")):
            part_cats[f"sphere_{i}_{hn}"] = 2 * (i + 1) + half
    for tp in picks:
        cam = cams[train_positions[tp]]
        seg_obj = np.load(os.path.join(ws, "gt_masks", f"{cam.image_name}.npy"))
        seg_part = np.load(os.path.join(ws, "gt_masks", f"{cam.image_name}_part.npy"))
        regions = [(cat_names[lab], seg_obj == lab) for lab in range(n_lab)]
        regions += [(cat, seg_part == pid) for cat, pid in part_cats.items()]
        objects = []
        for cat, region in regions:
            m = region.astype(np.uint8)
            if m.sum() < 64:
                continue
            ys, xs = np.nonzero(m)
            bbox = [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]
            for poly in mask_to_polygons(m):
                objects.append({"category": cat, "bbox": bbox, "segmentation": poly})
        jd = {"info": {"name": f"frame_{tp + 1:05d}.jpg",
                       "height": p.height, "width": p.width},
              "objects": objects}
        with open(os.path.join(json_dir, f"frame_{tp + 1:05d}.json"), "w") as fh:
            json.dump(jd, fh)
        Image.open(os.path.join(root, "images", f"{cam.image_name}.png")) \
            .save(os.path.join(json_dir, f"frame_{tp + 1:05d}.jpg"))

    # prompt embeddings: the categories and the relevancy negatives
    neg = rng.normal(size=(len(NEGATIVE_PROMPTS), p.embed_dim)).astype(np.float32)
    neg /= np.linalg.norm(neg, axis=1, keepdims=True)
    prompts = {cat_names[i]: embeds[i] for i in range(n_lab)}
    prompts.update({cat: part_embeds[pid] for cat, pid in part_cats.items()})
    prompts.update({q: neg[i] for i, q in enumerate(NEGATIVE_PROMPTS)})
    np.savez(os.path.join(ws, "text_embeddings.npz"), **prompts)
    seconds = time.perf_counter() - t0
    print(f"scene stage done in {seconds:.0f}s: {len(means)} GT gaussians, "
          f"{p.n_cams} cams", flush=True)
    return dict(gaussians=int(len(means)), cameras=p.n_cams, render_seconds=seconds)
