"""Work counts: the operations and bytes of the blend kernels (K1, K2), the segment sum
(K3) and of a whole training step or render, and the card's data-sheet peaks.

A kernel's bound is the larger of its bytes over the HBM rate and its FP32 operations
over the FP32 rate. Bytes count every input read once and every output written once;
operations count the work that these inputs need: the (instance, pixel) pairs that
blend, as the reference's blend counts them (a kernel that culls exactly evaluates no
other pair). The formulas are chip_smoke.py's `blend_bound`, `backward_bound` and
`segsum_bound`, except that K2's output is counted as one gradient row a listed
instance (what the function writes), not the program's padded instance budget.
"""

from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at its 700 W limit
FP32_OPS_PER_S = 67e12      # H100 SXM data sheet, FP32 outside the tensor cores
TILE = 16

#: FP32 operations a Gaussian of the field costs in the forward preprocess, hand-counted
#: from the reference (quaternion -> rotation 30, covariance 54, view and clip transforms
#: 28, EWA covariance 80, conic, eigenvalue radius and tile rect 30, SH degree 3 colour
#: with its direction 130): a floor, the sort and gathers of binning not counted
PREPROCESS_OPS = 350
#: the backward of the preprocess, at least the forward's count again
PREPROCESS_BWD_OPS = 350
#: Adam's operations a trained float (both moments, bias corrections, the update)
ADAM_OPS = 12
#: SSIM's forward a pixel and channel: 5 blurred maps, 2 separable passes of 11
#: multiply-adds, and the map's 20; its backward at least as many; L1 3 a value
SSIM_OPS = 2 * (5 * 2 * 2 * 11 + 20)
L1_OPS = 3


class Work(NamedTuple):
    nbytes: float
    ops: float

    def __add__(self, other):
        return Work(self.nbytes + other.nbytes, self.ops + other.ops)

    def bound_s(self) -> float:
        return max(self.nbytes / HBM_BYTES_PER_S, self.ops / FP32_OPS_PER_S)


def k1(n: int, features: int, instances: int, blended: int, width: int,
       height: int) -> Work:
    """The blend forward: per-Gaussian means2d, conics, opacity, visibility, colours and
    features, the listed instances and tile ranges read; the image (3 + F channels) and
    final T written. 11 operations a blended pair for the falloff, 6 + 2C for alpha,
    transmittance, weight and the C accumulations."""
    c = 3 + features
    tiles = -(-width // TILE) * -(-height // TILE)
    nbytes = (n * 4 * (2 + 3 + 1 + c) + n + 4 * instances + 4 * (tiles + 1) + 4 * 3
              + 4 * (c + 1) * width * height)
    return Work(nbytes, (11 + 6 + 2 * c) * blended)


def k2(n: int, features: int, feature_only: bool, instances: int, blended: int,
       width: int, height: int) -> Work:
    """The blend backward: the forward's per-Gaussian inputs, the instances and their
    pre-sort slots, tile ranges and C + 3 per-pixel gradient and residual values read;
    R gradient rows an instance written. Per blended pair 11 (the falloff), 30 + 3C
    (alpha, T, weight, the suffix and the chain to the six geometric gradients and the C
    attribute gradients) and R adds into the instance's sums; feature mode 11 + 6 + 2F."""
    c = 3 + features
    rows = features if feature_only else 9 + features
    tiles = -(-width // TILE) * -(-height // TILE)
    nbytes = (n * 4 * (2 + 3 + 1 + c) + n + 8 * instances + 4 * (tiles + 1)
              + 4 * (c + 3) * width * height + 4 * rows * instances)
    per_pair = (6 + 2 * features) if feature_only else (30 + 3 * c + rows)
    return Work(nbytes, (11 + per_pair) * blended)


def k3(n: int, features: int, feature_only: bool, instances: int) -> Work:
    """The segment sum: R rows of every instance column and the N + 1 segment ends read,
    the [R, N] sums written, one add an element read."""
    rows = features if feature_only else 9 + features
    return Work(4 * rows * instances + 4 * (n + 1) + 4 * rows * n, rows * instances)


def train_step(phase: str, capacity: int, trained_floats: int, features: int,
               instances: int, blended: int, width: int, height: int) -> Work:
    """One training step: the preprocess of every slot (and its backward in phase A),
    K1, K2, K3, the loss and its gradient, Adam over the trained floats. Bytes are the
    kernels' alone (a floor)."""
    feature_only = phase == "B"
    fwd_features = features if feature_only else 0
    work = (k1(capacity, fwd_features, instances, blended, width, height)
            + k2(capacity, fwd_features, feature_only, instances, blended, width, height)
            + k3(capacity, fwd_features, feature_only, instances))
    pixels = width * height
    ops = PREPROCESS_OPS * capacity + ADAM_OPS * trained_floats
    if feature_only:
        ops += 2 * L1_OPS * features * pixels
    else:
        ops += PREPROCESS_BWD_OPS * capacity + 3 * pixels * (SSIM_OPS + 2 * L1_OPS)
    return work + Work(0, ops)


def render_view(capacity: int, features: int, instances: int, blended: int, width: int,
                height: int) -> Work:
    """One render: the preprocess of every slot and K1."""
    return k1(capacity, features, instances, blended, width, height) + Work(
        0, PREPROCESS_OPS * capacity)
