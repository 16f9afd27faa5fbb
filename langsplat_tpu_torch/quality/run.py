"""The end-to-end quality protocol on the port: the `process.sh` + `eval/eval.sh`
pipeline on the synthetic scene of `quality/scene.py`, through the port's CLIs
(`scripts/quality_run.py`'s stages, without JAX or OpenCV):

  scene    the GT scene (`scene.stage_scene`);
  ae       the autoencoder train and test CLIs (512 -> 3, 400 epochs);
  oracle   the eval CLI on the AE-encoded GT feature maps: the mIoU ceiling;
  phaseA   the train CLI, RGB with densification and opacity resets (--eval split,
           tests every 2,500 iterations);
  phaseB   the train CLI at feature levels 1-3 from the phase-A checkpoint;
  render   the render CLI: RGB of the test split, features of the train split;
  evalrun  the eval CLI on the trained field's feature maps;
  report   the report, with the keys of QUALITY_r04.json, read from the stages' logs,
           and each stage's seconds, the kernel launches of each stage
           (`ops/_build.LAUNCHES`) and the card's name and power limit.

    python -m langsplat_tpu_torch.quality.run --ws <dir> [--stages phaseA,phaseB,...]
        [--report_path <file>] [--smoke] [--device cpu]

It runs on the CUDA card unless --device says otherwise, and fails without one. Each
stage's seconds go to `<ws>/stage_times.json` and its launches to
`<ws>/stage_launches.json`; each training run and level writes its own log, replaced
on every attempt. --smoke runs every stage at a tiny size in `<ws>_smoke`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

from langsplat_tpu_torch.quality.scene import QualityParams, stage_scene

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
STAGES = ("scene", "ae", "oracle", "phaseA", "phaseB", "render", "evalrun", "report")
LEVELS = (1, 2, 3)
AE_ENCODER = [256, 128, 64, 32, 3]
AE_DECODER = [16, 32, 64, 128, 256, 256, 512]
PROTOCOL = ("self-consistency synthetic-COLMAP scene, full process.sh-shaped pipeline "
            "(AE 512->3, phase A RGB with densification, phase B levels 1-3, render, "
            "LERF IoU/loc eval)")
PSNR_LINE = re.compile(r"\[ITER (\d+)\] Evaluating (\w+): L1 ([\d.eE+-]+) "
                       r"PSNR ([\d.eE+-]+)")
FEATURE_L1_LINE = re.compile(r"\[ITER (\d+)\] Evaluating (\w+): feature-L1 "
                             r"([\d.eE+-]+)")
PROGRESS_LINE = re.compile(r"iter (\d+): \S+ n=(\d+)")


@dataclasses.dataclass(frozen=True)
class Run:
    """A protocol run: its workspace, parameters and device argument ("cpu", or None
    for the card)."""
    ws: str
    params: QualityParams
    device: str | None

    def path(self, *parts: str) -> str:
        return os.path.join(self.ws, *parts)

    @property
    def scene_dir(self) -> str:
        return self.path("scene")

    @property
    def out(self) -> str:
        return self.path("output", self.params.scene)

    def device_flags(self) -> list[str]:
        return ["--device", self.device] if self.device else []

    def pipe_flags(self) -> list[str]:
        return ["--budget_factor", str(self.params.budget_factor)] + self.device_flags()


class Tee(io.TextIOBase):
    def __init__(self, *sinks):
        self.sinks = sinks

    def write(self, s):
        for k in self.sinks:
            k.write(s)
            k.flush()
        return len(s)


def run_logged(fn, argv, log_path: str):
    """fn(argv) with its output also written to `log_path`, replaced on every attempt
    (a reused workspace must not interleave two attempts' curves)."""
    with open(log_path, "w") as fh:
        with contextlib.redirect_stdout(Tee(sys.stdout, fh)):
            return fn(argv)


def stage_ae(run: Run) -> dict:
    from langsplat_tpu_torch.cli.autoencoder_cli import test_main, train_main
    p = run.params
    common = ["--dataset_path", run.scene_dir, "--dataset_name", p.scene,
              "--ckpt_root", run.path("ckpt")] + run.device_flags()
    res = train_main(common + ["--num_epochs", str(p.ae_epochs)])
    test_main(common)
    return dict(best_epoch=res["best_epoch"], best_loss=res["best_loss"],
                rows=res["rows"], steps_per_epoch=res["steps_per_epoch"])


def stage_phase_a(run: Run) -> dict:
    from langsplat_tpu_torch.cli.train_cli import main as train_main
    p = run.params
    tests = list(range(p.test_every, p.iters_a + 1, p.test_every))
    argv = ["-s", run.scene_dir, "-m", run.out, "--no_include_feature", "--eval",
            "--resolution", "1",
            "--iterations", str(p.iters_a),
            "--densify_from_iter", str(p.densify_from),
            "--densification_interval", str(p.densification_interval),
            "--densify_until_iter", str(p.densify_until),
            "--opacity_reset_interval", str(p.opacity_reset_interval),
            "--densify_grad_threshold", str(p.densify_grad_threshold),
            # headroom for densification growth (the GT field is 112k)
            "--initial_capacity_factor", "6",
            "--test_iterations"] + [str(t) for t in tests] + [
            "--save_iterations", str(p.iters_a),
            "--checkpoint_iterations", str(p.iters_a)] + run.pipe_flags()
    res = run_logged(train_main, argv, run.path("phaseA.log"))
    return dict(capacity=res["field"].capacity, alive=res["field"].num_alive)


def stage_phase_b(run: Run) -> dict:
    from langsplat_tpu_torch.cli.train_cli import main as train_main
    from langsplat_tpu_torch.ops import _build
    p = run.params
    ck = f"{run.out}_-1/chkpnt{p.iters_a}.npz"
    levels = {}
    for lvl in LEVELS:
        before = dict(_build.LAUNCHES)
        argv = ["-s", run.scene_dir, "-m", run.out, "--eval", "--resolution", "1",
                "--feature_level", str(lvl),
                "--iterations", str(p.iters_b),
                "--start_checkpoint", ck,
                "--test_iterations", str(p.iters_b),
                "--save_iterations", str(p.iters_b),
                "--checkpoint_iterations", str(p.iters_b)] + run.pipe_flags()
        run_logged(train_main, argv, run.path(f"phaseB_{lvl}.log"))
        levels[str(lvl)] = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    return dict(launches_by_level=levels)


def stage_render(run: Run) -> dict:
    from langsplat_tpu_torch.cli.render_cli import main as render_main
    render_main(["-m", f"{run.out}_-1", "--skip_train"] + run.pipe_flags())
    for lvl in LEVELS:
        render_main(["-m", f"{run.out}_{lvl}", "--include_feature", "--skip_test"]
                    + run.pipe_flags())
    return {}


def _eval(run: Run, feat_dir: str, output_dir: str, extra: list[str]) -> dict:
    from langsplat_tpu_torch.cli.eval_cli import main as eval_main
    p = run.params
    res = eval_main(["--dataset_name", p.scene, "--feat_dir", feat_dir,
                     "--ae_ckpt_dir", run.path("ckpt"),
                     "--json_folder", run.path("label"),
                     "--output_dir", output_dir,
                     "--text_embeddings", run.path("text_embeddings.npz")]
                    + extra + run.device_flags())
    return {"miou": float(res["miou"]), "localization_acc": float(res["localization_acc"]),
            "chosen_levels": [int(x) for x in res["chosen_levels"]]}


def stage_eval(run: Run) -> dict:
    # --no_vis: the report reads no PNG, and the card's machine has no matplotlib
    res = _eval(run, run.path("output"), run.path("eval_result"),
                ["--iteration", str(run.params.iters_b), "--no_vis"])
    with open(run.path("eval_result.json"), "w") as fh:
        json.dump(res, fh)
    print("eval:", res)
    return {"miou": res["miou"], "localization_acc": res["localization_acc"]}


def stage_oracle(run: Run) -> dict:
    """The eval on GT feature maps: the scene's own per-pixel 512-d features encoded
    to 3-d by the AE, without training or rendering. Its mIoU is the ceiling the
    trained field can approach: it isolates the AE's compression and the eval protocol
    from the field's quality."""
    import torch

    from langsplat_tpu_torch.cli.autoencoder_cli import load_ae_checkpoint
    from langsplat_tpu_torch.device import float32_matmul_highest, resolve_device

    p = run.params
    device = resolve_device(run.device)
    float32_matmul_highest()
    lf_dir = os.path.join(run.scene_dir, "language_features")
    model = load_ae_checkpoint(run.path("ckpt", p.scene, "best_ckpt.npz"),
                               AE_ENCODER, AE_DECODER).to(device)

    # annotated frames are train-split positions (label/frame_{tp+1:05d}.json); the
    # eval indexes the sorted renders by position, so every position up to the last
    # exists, unannotated ones as zeros (never read)
    train_positions = p.train_positions()
    annotated = {int(os.path.basename(jp)[6:11]) - 1
                 for jp in glob.glob(run.path("label", p.scene, "frame_*.json"))}
    for lvl in LEVELS:
        out_dir = run.path("eval_oracle", "output", f"{p.scene}_{lvl}", "train",
                           "ours_None", "renders_npy")
        os.makedirs(out_dir, exist_ok=True)
        for tp in range(len(train_positions)):
            path = os.path.join(out_dir, f"{tp:05d}.npy")
            if tp not in annotated:
                np.save(path, np.zeros((p.height, p.width, 3), np.float16))
                continue
            name = f"frame_{train_positions[tp] + 1:05d}"
            seg4 = np.load(os.path.join(lf_dir, name + "_s.npy"))
            table = np.load(os.path.join(lf_dir, name + "_f.npy")).astype(np.float32)
            with torch.no_grad():
                codes = model.encode(torch.as_tensor(table).to(device)).cpu().numpy()
            seg = seg4[lvl].astype(np.int64)
            feat3 = codes[np.clip(seg, 0, len(codes) - 1)]
            feat3[seg < 0] = 0.0
            np.save(path, feat3.astype(np.float16))          # [H, W, 3]

    res = _eval(run, run.path("eval_oracle", "output"), run.path("eval_oracle", "result"),
                ["--no_vis"])
    oracle = {"miou": res["miou"], "localization_acc": res["localization_acc"]}
    with open(run.path("eval_oracle.json"), "w") as fh:
        json.dump(oracle, fh)
    print("eval oracle:", oracle["miou"], oracle["localization_acc"])
    return oracle


def device_description(device: str | None) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them; "cpu" for a CPU run."""
    if device is not None and not str(device).startswith("cuda"):
        return str(device)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch
        return f"{torch.cuda.get_device_name(0)}, power limit not read"


def _read_json(path: str):
    try:
        with open(path) as fh:
            return json.load(fh)
    except FileNotFoundError:
        return None


def stage_report(run: Run, out_path: str) -> dict:
    p = run.params
    curve = []
    with open(run.path("phaseA.log")) as fh:
        for line in fh:
            m = PSNR_LINE.search(line)
            if m and m.group(2) == "test":
                curve.append({"iter": int(m.group(1)), "psnr": float(m.group(4)),
                              "l1": float(m.group(3))})
    # final test PSNR from the rendered test split
    test_dir = run.path("output", f"{p.scene}_-1", "test")
    ours = sorted(glob.glob(os.path.join(test_dir, "ours_*")))[-1]
    psnrs = []
    for rp in sorted(glob.glob(os.path.join(ours, "renders_npy", "*.npy"))):
        r = np.load(rp)
        g = np.load(os.path.join(ours, "gt_npy", os.path.basename(rp)))
        mse = float(np.mean((r - g) ** 2))
        psnrs.append(-10 * np.log10(max(mse, 1e-12)))
    ev = _read_json(run.path("eval_result.json"))
    # phase B's masked feature-channel L1 per level, from the feature-L1 test lines
    # (the RGB "L1" lines are constant in phase B: the geometry is frozen)
    feat_l1 = {}
    for lvl in LEVELS:
        try:
            with open(run.path(f"phaseB_{lvl}.log")) as fh:
                vals = [float(m.group(3)) for m in (FEATURE_L1_LINE.search(x) for x in fh)
                        if m and m.group(2) == "test"]
        except FileNotFoundError:
            continue
        if vals:
            feat_l1[str(lvl)] = vals[-1]
    oracle = _read_json(run.path("eval_oracle.json"))
    ply = run.path("output", f"{p.scene}_-1", "point_cloud", f"iteration_{p.iters_a}",
                   "point_cloud.ply")
    n_final = None
    if os.path.exists(ply):
        from langsplat_tpu_torch.models import field_io
        n_final = int(field_io.load_ply(ply, device="cpu").num_alive)
    # the Gaussian count from the progress lines: growth, and the prune after resets
    traj = {}
    with open(run.path("phaseA.log")) as fh:
        for line in fh:
            m = PROGRESS_LINE.search(line)
            if m:
                traj[int(m.group(1))] = int(m.group(2))
    n_curve = [{"iter": it, "n": traj[it]}
               for it in sorted(traj) if it % 500 == 0 or it == max(traj)]
    report = {
        "protocol": PROTOCOL,
        "scene": {"gaussians_gt": p.gaussians_gt, "init_points": p.init_pts,
                  "cameras": p.n_cams, "image": [p.width, p.height],
                  "objects": p.n_objects + 1, "gaussians_final": n_final,
                  "gaussians_peak": max(traj.values()) if traj else None,
                  "gaussians_curve": n_curve},
        "phase_a": {"iterations": p.iters_a, "psnr_curve": curve,
                    "final_test_psnr_mean": float(np.mean(psnrs)) if psnrs else None,
                    "final_test_psnr_per_view": [round(x, 3) for x in psnrs]},
        "phase_b": {"iterations": p.iters_b, "final_test_feature_l1": feat_l1},
        "eval": ev,
        "eval_oracle": oracle,
        "device": device_description(run.device),
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "params": dataclasses.asdict(p),
        "stage_seconds": _read_json(run.path("stage_times.json")),
        "launches": _read_json(run.path("stage_launches.json")),
    }
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"final_test_psnr": report["phase_a"]["final_test_psnr_mean"],
                      "miou": (ev or {}).get("miou"),
                      "localization_acc": (ev or {}).get("localization_acc"),
                      "oracle_miou": (oracle or {}).get("miou")}))
    return report


def run_stages(run: Run, stages, report_path: str) -> dict:
    """Run `stages` in order, recording each one's seconds and kernel launches in the
    workspace; returns {stage: what it returned}."""
    import torch

    from langsplat_tpu_torch.device import resolve_device
    from langsplat_tpu_torch.ops import _build

    unknown = [s for s in stages if s not in STAGES]
    if unknown:
        raise ValueError(f"unknown stages {unknown}; the stages are {STAGES}")
    device = resolve_device(run.device)
    os.makedirs(run.ws, exist_ok=True)
    times = _read_json(run.path("stage_times.json")) or {}
    launches = _read_json(run.path("stage_launches.json")) or {}
    known = [st for st in stages if st in times]
    if known:
        print(f"ETA (recorded stages {','.join(known)}): "
              f"{sum(times[st] for st in known) / 60:.0f} min", flush=True)
    results = {}
    t_all = time.perf_counter()
    for st in stages:
        print(f"=== stage {st} ===", flush=True)
        for key in _build.LAUNCHES:
            _build.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        if st == "scene":
            results[st] = stage_scene(run.ws, run.params, device)
        elif st == "report":
            results[st] = stage_report(run, report_path)
        else:
            results[st] = {"ae": stage_ae, "oracle": stage_oracle,
                           "phaseA": stage_phase_a, "phaseB": stage_phase_b,
                           "render": stage_render, "evalrun": stage_eval}[st](run)
        if device.type == "cuda":
            torch.cuda.synchronize()
        times[st] = round(time.perf_counter() - t0, 1)
        if st != "report":
            launches[st] = dict(_build.LAUNCHES)
            if st == "phaseB":
                launches["phaseB_levels"] = results[st]["launches_by_level"]
        for name, record in (("stage_times.json", times),
                             ("stage_launches.json", launches)):
            with open(run.path(name), "w") as fh:
                json.dump(record, fh, indent=1)
        print(f"=== {st} done ({times[st]:.0f}s stage, "
              f"{time.perf_counter() - t_all:.0f}s elapsed) ===", flush=True)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ws", default=os.path.join(REPO, ".quality_ws_torch"),
                    help="workspace directory (--smoke appends _smoke)")
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--smoke", action="store_true",
                    help="every stage at a tiny size")
    ap.add_argument("--report_path", default=None,
                    help="report file (default: <ws>/QUALITY_torch.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    params = QualityParams.smoke() if args.smoke else QualityParams()
    ws = args.ws + "_smoke" if args.smoke else args.ws
    report_path = args.report_path or os.path.join(ws, "QUALITY_torch.json")
    return run_stages(Run(ws, params, args.device), args.stages.split(","), report_path)


if __name__ == "__main__":
    main(sys.argv[1:])
