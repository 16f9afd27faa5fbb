"""Densification under the Gaussian-sharded layout: shard-local slot allocation.

Counterpart of `langsplat_tpu/parallel/gauss_densify.py:49 make_sharded_densify`. The
clone / split / prune decisions are per row (gradient norm, scale and opacity tests), so
each rank runs the serial `densify_core` on its own rows and places the children in its
own free rows: the decisions equal the serial rule's on any mesh, only which row a child
lands in depends on the mesh. The split noise is drawn for the whole capacity (the same
draw on every rank) and sliced by rows, so it matches the serial draw slot for slot.
Overflow is summed over the ranks and conservative: a full shard reports overflow even
when another has spare rows, so the capacity grows at least as early as the serial rule
would grow it. `num_alive` is summed.
"""

from __future__ import annotations

import torch

from langsplat_tpu_torch.parallel import collectives as col
from langsplat_tpu_torch.train.densify import DensifyResult, DensifyStats, densify_core


def sharded_densify(field, stats: DensifyStats, noise: torch.Tensor, *, group=None,
                    extent: float, grad_threshold: float = 0.0002,
                    percent_dense: float = 0.01, min_opacity: float = 0.005,
                    use_size_threshold: bool = False,
                    size_threshold: float = 20.0) -> DensifyResult:
    """Densify this rank's rows of the field and statistics with rows [r c, (r+1) c) of
    the full-capacity split noise `noise` [n c, 2, 3]. field, statistics and reset_mask
    stay this rank's; overflow and num_alive are the group's sums."""
    rows, r = field.capacity, col.rank(group)
    res = densify_core(field, stats, noise[r * rows:(r + 1) * rows], extent=extent,
                       grad_threshold=grad_threshold, percent_dense=percent_dense,
                       min_opacity=min_opacity, use_size_threshold=use_size_threshold,
                       size_threshold=size_threshold)
    counts = col.sum_(torch.stack([res.overflow.to(torch.int64),
                                   res.num_alive.to(torch.int64)]), group)
    return res._replace(overflow=counts[0], num_alive=counts[1])
