"""PyTorch port, bounded segment sum: the plain version of `segment_sum` against the JAX
package's `segment_sum_bounded` (Pallas, interpret mode) and numpy, on the segment
layouts of tests/test_pallas_blend.py:251-271 plus segments longer than 32 (the tile
cap can grow to the whole grid). (The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py.)

Tolerance: 1e-5 absolute (sums of at most ~100 values of order 1, in another order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplat_tpu.ops.segsum_pallas import segment_sum_bounded
from langsplat_tpu_torch.ops import _build
from langsplat_tpu_torch.ops.segsum import segment_sum, segment_sum_cuda

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

ATOL = 1e-5


def layout(n_out, max_len, rows, seed, long=()):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, n_out)
    lens[rng.uniform(size=n_out) < 0.3] = 0          # empty segments
    for i, length in long:
        lens[i] = length
    ends = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    width = int(ends[-1])
    d = rng.normal(size=(rows, max(width, 1))).astype(np.float32)[:, :width]
    return d, ends


@pytest.mark.parametrize("n_out,max_len,rows,long", [
    (700, 7, 12, ()), (513, 1, 3, ()), (64, 32, 8, ()),
    (300, 3, 12, ((5, 33), (150, 97), (299, 64))),
])
def test_plain_matches_jax_and_numpy(n_out, max_len, rows, long):
    d, ends = layout(n_out, max_len, rows, seed=11, long=long)
    jout = segment_sum_bounded(jnp.asarray(d if d.shape[1] else
                                           np.zeros((rows, 0), np.float32)),
                               jnp.asarray(ends), n_out, interpret=True,
                               block_in=128, block_out=256)
    launches = _build.LAUNCHES["segsum"]
    out = segment_sum(torch.tensor(d), torch.tensor(ends), n_out)
    assert _build.LAUNCHES["segsum"] == launches      # CPU tensors: the plain version
    expect = np.zeros((rows, n_out), np.float32)
    for g in range(n_out):
        expect[:, g] = d[:, ends[g]:ends[g + 1]].sum(axis=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), expect, atol=ATOL)


def test_columns_outside_the_segments_are_ignored():
    """The blend backward's d_pre is budget wide; only [ends[0], ends[-1]) counts."""
    d = torch.arange(40, dtype=torch.float32).reshape(2, 20)
    ends = torch.tensor([3, 5, 5, 9], dtype=torch.int32)
    out = segment_sum(d, ends, 3)
    np.testing.assert_array_equal(out.numpy(), [[3 + 4, 0, 5 + 6 + 7 + 8],
                                                [23 + 24, 0, 25 + 26 + 27 + 28]])


def test_cuda_wrapper_refuses_cpu_tensors_and_bad_shapes():
    d, ends = torch.zeros((2, 8)), torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_cuda(d, ends, 4)
    with pytest.raises(ValueError, match="ends"):
        segment_sum(d, ends, 3)
