"""K-nearest-neighbour mean squared distance, for the scale initialisation of a field.

PyTorch counterpart of `langsplat_tpu/ops/knn.py`: per point, the mean of the squared
distances to its 3 nearest other points. Chunked brute force: each chunk of queries
computes its squared distances to all points as |q|^2 - 2 q.p + |p|^2 (the cross term
one `torch.matmul`, in float32: matmuls do not use TF32 unless asked) and keeps the k
smallest with `torch.topk`. It runs once per scene, outside any kernel, as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

import torch

#: elements of one chunk's [chunk, N] distance matrix (1 GiB of float32)
CHUNK_ELEMENTS = 1 << 28


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3, chunk: int = 1024) -> torch.Tensor:
    """points [N, 3] -> [N] mean squared distance to each point's k nearest neighbours.
    The chunk shrinks for large N so that one chunk's distances stay within
    CHUNK_ELEMENTS."""
    n = points.shape[0]
    chunk = max(1, min(chunk, CHUNK_ELEMENTS // max(n, 1)))
    sq = torch.sum(points * points, dim=-1)
    out = torch.empty((n,), dtype=points.dtype, device=points.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        q = points[lo:hi]
        d2 = sq[lo:hi, None] - 2.0 * torch.matmul(q, points.T) + sq[None, :]
        rows = torch.arange(hi - lo, device=points.device)
        d2[rows, rows + lo] = torch.inf          # self-distance
        nearest = torch.topk(d2, k, dim=1, largest=False).values
        out[lo:hi] = torch.mean(torch.clamp_min(nearest, 0.0), dim=-1)
    return out
