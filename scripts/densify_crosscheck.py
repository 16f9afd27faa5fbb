"""Densification inputs of the JAX package and the port, from their checkpoints.

    python scripts/densify_crosscheck.py train <max_per_tile> <train CLI flags...>
        the JAX train CLI on the CPU (--interpret: the tiled backend) with the tiled
        backend's per-tile cap raised from its 1,024 instances, so that no tile
        truncates its farthest instances; the Pallas path has no such cap

    python scripts/densify_crosscheck.py compare <chkpnt_a.npz> <chkpnt_b.npz> [threshold]
        the densification statistics of two phase-A checkpoints of the same run length
        (either package's): visible Gaussians, equal denominators, the Gaussians whose
        mean screen-space gradient reaches the threshold (2e-4) in each and in both,
        and how many differ by more than 1e-4 ... 1e-1 relative

Used on the quality protocol's scene (ROADMAP, PR 9's densification readings): run
`train` and the port's train CLI (`--device cpu`) with the same flags and
`--checkpoint_iterations N`, then `compare` the two `chkpnt<N>.npz`.
"""

import dataclasses
import json
import os
import sys

import numpy as np


def train(max_per_tile: int, argv: list[str]) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    from langsplat_tpu.cli.train_cli import main
    from langsplat_tpu.train import loop

    make_settings = loop.make_settings
    loop.make_settings = lambda *a, **k: dataclasses.replace(make_settings(*a, **k),
                                                             max_per_tile=max_per_tile)
    main(argv)


def compare(path_a: str, path_b: str, threshold: float = 2e-4) -> dict:
    with np.load(path_a) as a, np.load(path_b) as b:
        # stats_0: accumulated gradient norms, stats_1: visible-step counts
        ga, da, gb, db = a["stats_0"], a["stats_1"], b["stats_0"], b["stats_1"]
    vis = da > 0
    ma = np.where(vis, ga / np.maximum(da, 1), 0.0)
    mb = np.where(db > 0, gb / np.maximum(db, 1), 0.0)
    rel = np.abs(ga - gb) / np.maximum(np.abs(ga), 1e-12)
    return dict(visible=[int(vis.sum()), int((db > 0).sum())],
                denominators_equal=bool((da == db).all()),
                above_threshold=[int((ma >= threshold).sum()), int((mb >= threshold).sum()),
                                 int(((ma >= threshold) & (mb >= threshold)).sum())],
                rel_diff_over={str(t): int((rel[vis] > t).sum())
                               for t in (1e-4, 1e-3, 1e-2, 1e-1)},
                grad_sum=[float(ga.sum()), float(gb.sum())])


if __name__ == "__main__":
    if sys.argv[1] == "train":
        train(int(sys.argv[2]), sys.argv[3:])
    else:
        print(json.dumps(compare(*sys.argv[2:4], *map(float, sys.argv[4:5]))))
