"""The quality protocol's autoencoder against the JAX package's, on one staged scene
(ROADMAP F4): how far the port's AE drifts from the JAX CLI's when both start from the
same init and see the same batches, and what the oracle scores for each checkpoint.

    python -m langsplat_tpu_torch.quality.ae_compare --ws <ws> --jax_dir <dir>
        [--epochs 1 10 50 100 200 400] [--device cpu]

<ws> holds a staged scene (`python -m langsplat_tpu_torch.quality.run --stages scene`);
<dir> holds the JAX CLI's checkpoints as `quality_ae_crosscheck.sh jax` writes them:
init.npz (--num_epochs 0: the JAX init), e<E>.npz (--num_epochs E --eval_from_frac 1.0:
the state after E epochs), best.npz (the protocol's 400-epoch run) and oracle.json (the
JAX script's oracle of best.npz). The result, also in <ws>/ae_compare.json:

  drift   for each E, the largest difference of the scene rows' 3-d codes, the port's
          AE against the JAX CLI's, both E epochs from JAX's init;
  oracle  the port's oracle of JAX's best.npz beside the JAX script's, and the port's
          oracle of its own protocol AE from JAX's init and from its own init, each
          with its largest code difference from best.npz.

Codes are computed on the CPU; the training and the oracle run on the card unless
--device says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

from langsplat_tpu_torch.quality.run import AE_DECODER, AE_ENCODER, Run, stage_oracle
from langsplat_tpu_torch.quality.scene import QualityParams


def codes(ckpt: str, rows: np.ndarray) -> np.ndarray:
    """The 3-d codes of `rows` [N, 512] under the checkpoint, on the CPU."""
    from langsplat_tpu_torch.cli.autoencoder_cli import load_ae_checkpoint
    model = load_ae_checkpoint(ckpt, AE_ENCODER, AE_DECODER)
    with torch.no_grad():
        return model.encode(torch.as_tensor(rows)).numpy()


def scene_rows(run: Run) -> np.ndarray:
    from langsplat_tpu_torch.cli.autoencoder_cli import load_feature_dataset
    return load_feature_dataset(os.path.join(run.scene_dir, "language_features"))[0]


def train_port(run: Run, name: str, epochs: int, extra: list[str]) -> str:
    """The port's AE CLI on `run`'s scene for `epochs` epochs; -> its checkpoint."""
    from langsplat_tpu_torch.cli.autoencoder_cli import train_main
    root = run.path("ae_compare", "train", name)
    train_main(["--dataset_path", run.scene_dir, "--dataset_name", run.params.scene,
                "--ckpt_root", root, "--num_epochs", str(epochs)]
               + extra + run.device_flags())
    return os.path.join(root, run.params.scene, "best_ckpt.npz")


def oracle_of(run: Run, ckpt: str, name: str) -> dict:
    """The oracle stage of `run`'s scene with the AE checkpoint `ckpt`, in the
    workspace <ws>/ae_compare/<name> (the scene, labels and prompts linked, not
    copied)."""
    sub = Run(run.path("ae_compare", name), run.params, run.device)
    os.makedirs(sub.path("ckpt", run.params.scene), exist_ok=True)
    for part in ("scene", "label", "text_embeddings.npz"):
        if not os.path.lexists(sub.path(part)):
            os.symlink(os.path.abspath(run.path(part)), sub.path(part))
    shutil.copy(ckpt, sub.path("ckpt", run.params.scene, "best_ckpt.npz"))
    return stage_oracle(sub)


def compare(run: Run, jax_dir: str, epochs) -> dict:
    rows = scene_rows(run)
    init = os.path.join(jax_dir, "init.npz")
    best = os.path.join(jax_dir, "best.npz")
    drift = {}
    for e in epochs:
        ours = train_port(run, f"e{e}", e, ["--eval_from_frac", "1.0", "--init_ckpt", init])
        theirs = os.path.join(jax_dir, f"e{e}.npz")
        drift[str(e)] = float(np.abs(codes(ours, rows) - codes(theirs, rows)).max())
        print(f"drift after {e} epochs: {drift[str(e)]:.3g}", flush=True)
    with open(os.path.join(jax_dir, "oracle.json")) as fh:
        jax_oracle = json.load(fh)
    oracle = {"jax_best": {"port": oracle_of(run, best, "jax_best"), "jax": jax_oracle}}
    best_codes = codes(best, rows)
    for name, extra in (("port_from_jax_init", ["--init_ckpt", init]),
                        ("port_own_init", [])):
        ckpt = train_port(run, name, run.params.ae_epochs, extra)
        oracle[name] = dict(oracle_of(run, ckpt, name), code_diff_from_jax_best=float(
            np.abs(codes(ckpt, rows) - best_codes).max()))
    return {"rows": int(rows.shape[0]), "drift": drift, "oracle": oracle}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ws", required=True)
    ap.add_argument("--jax_dir", required=True)
    ap.add_argument("--epochs", nargs="+", type=int, default=[1, 10, 50, 100, 200, 400])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    result = compare(Run(args.ws, QualityParams(), args.device), args.jax_dir,
                     args.epochs)
    with open(os.path.join(args.ws, "ae_compare.json"), "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
