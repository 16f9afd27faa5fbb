// Bounded segment sum, for Hopper (sm_90a).
//
// Replaces the TPU kernel langsplat_tpu/ops/segsum_pallas.py::_kernel (:42), launched
// there by segment_sum_bounded (:89) from the packing-gather backward
// (rasterize_pallas.py:_gather_attrs_bwd, :253). Same contract:
//   out[r, g] = sum_{j = ends[g]}^{ends[g+1] - 1} d_pre[r, j]
// for rows r < R and Gaussians g < N, with `ends` monotone in [0, width]. Here d_pre
// holds the blend backward's per-instance sums in Gaussian-major (pre-sort) slot
// order, so each Gaussian's instances are one contiguous segment.
//
// What bounds it on this card: device-memory bytes. Every input column is read once
// and every output written once, with one add per input element.
//
// Design: one thread per Gaussian, looping over the rows and over its own segment in
// ascending slot order (a fixed order: the result is deterministic, no atomics).
// Segments are contiguous and short (about 1.5 instances per Gaussian on average), so
// the threads of a warp read neighbouring columns of each row and write neighbouring
// outputs. Segment length is not bounded: a Gaussian whose tile rect spans the whole
// grid just loops longer. The TPU kernel's one-hot membership matmul on the MXU has no
// purpose here.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ d_pre,   // [rows, width]
              const int* __restrict__ ends,      // [n + 1], clipped to [0, width]
              int rows, int width, int n,
              float* __restrict__ out)           // [rows, n]
{
    const int g = blockIdx.x * kThreads + threadIdx.x;
    if (g >= n) return;
    const int lo = ends[g];
    const int hi = ends[g + 1];
    for (int r = 0; r < rows; ++r) {
        const float* row = d_pre + static_cast<size_t>(r) * width;
        float s = 0.0f;
        for (int j = lo; j < hi; ++j) s += row[j];
        out[static_cast<size_t>(r) * n + g] = s;
    }
}

}  // namespace

// C entry point for ctypes. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int segsum(const void* d_pre, const void* ends, int rows, int width, int n,
                      void* out, void* stream) {
    if (n > 0) {
        segsum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float*>(d_pre), static_cast<const int*>(ends), rows, width,
            n, static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
