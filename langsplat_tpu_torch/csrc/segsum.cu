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
// Design: one block of 256 threads per 256 consecutive Gaussians, one thread per
// Gaussian. The block's segments form one contiguous span of columns in each row,
// ends[g0] .. ends[g0 + 256]. On the training path a Gaussian holds 8-12 instances
// (8.3 per slot of capacity, 12.4 per alive Gaussian), so a span is ~2-3k columns and
// one thread's own columns are ~33-50 bytes from its neighbours': read straight from
// device memory, a warp's loads would scatter. Instead the block stages each row's
// span through shared memory in chunks of kChunk floats with 16-byte cp.async copies
// of the 16-byte-aligned superset of the span (the words outside it are loaded and
// never read; a last word that would run past the array is copied 4 bytes at a time),
// double-buffered so that the next chunk is in flight while the current one is summed.
// The stages run row by row, chunk by chunk. Each thread then adds its own segment's
// columns of the chunk from shared memory in ascending column order, carrying its
// partial sum from chunk to chunk, so every output is the same left-to-right sum as the
// plain version's on the CPU, bit for bit (deterministic, no atomics). A segment longer
// than a chunk (the tile cap grows to the whole grid) just spans several chunks. After
// a row's last chunk the 256 sums are written, coalesced. d_pre must start 16-byte
// aligned (the wrapper checks).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 4096;   // floats per stage buffer (16 KB)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {   // all but the newest group
    asm volatile("cp.async.wait_group 1;\n" ::);
}

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ d_pre,   // [rows, width], 16-byte aligned
              const int* __restrict__ ends,      // [n + 1], clipped to [0, width]
              int rows, int width, int n,
              float* __restrict__ out)           // [rows, n]
{
    __shared__ __align__(16) float s_buf[2][kChunk];

    const int g0 = blockIdx.x * kThreads;
    const int g = g0 + threadIdx.x;
    const bool mine = g < n;
    const long long span_lo = ends[g0];
    const long long span_len = ends[min(g0 + kThreads, n)] - span_lo;
    const long long lo = mine ? ends[g] : 0;
    const long long hi = mine ? ends[g + 1] : 0;
    const long long total = static_cast<long long>(rows) * width;

    if (span_len == 0 || rows == 0) {   // every segment of the block is empty
        if (mine)
            for (int r = 0; r < rows; ++r) out[static_cast<size_t>(r) * n + g] = 0.0f;
        return;
    }

    // stage (r, c): chunk c of row r's aligned span, flat indices [first, first + count)
    auto row_begin = [&](int r) { return static_cast<long long>(r) * width + span_lo; };
    auto row_base = [&](int r) { return row_begin(r) & ~3LL; };
    auto row_chunks = [&](int r) {
        return static_cast<int>((row_begin(r) + span_len - row_base(r) + kChunk - 1) /
                                kChunk);
    };
    auto issue = [&](int r, int c, float* buf) {
        const long long first = row_base(r) + static_cast<long long>(c) * kChunk;
        const long long count = min(static_cast<long long>(kChunk),
                                    row_begin(r) + span_len - first);
        const int vecs = static_cast<int>((count + 3) / 4);
        for (int v = threadIdx.x; v < vecs; v += kThreads) {
            const long long e = first + 4LL * v;
            if (e + 4 <= total) {
                cp_async16(buf + 4 * v, d_pre + e);
            } else {
                for (int k = 0; k < 4 && e + k < total; ++k)
                    cp_async4(buf + 4 * v + k, d_pre + e + k);
            }
        }
    };

    int r = 0, c = 0, stage = 0;
    int chunks = row_chunks(0);
    issue(0, 0, s_buf[0]);
    cp_async_commit();
    float acc = 0.0f;
    while (true) {
        int next_r = r, next_c = c + 1;
        if (next_c == chunks) {
            next_r = r + 1;
            next_c = 0;
        }
        const bool more = next_r < rows;
        if (more) issue(next_r, next_c, s_buf[(stage + 1) & 1]);
        cp_async_commit();       // possibly empty: the wait below then covers this stage
        cp_async_wait_prior();
        __syncthreads();         // every thread's copies of this stage have landed

        const float* buf = s_buf[stage & 1];
        const long long first = row_base(r) + static_cast<long long>(c) * kChunk;
        const long long row0 = static_cast<long long>(r) * width;
        const long long a = max(row0 + lo, first) - first;
        const long long b = min(row0 + hi, first + kChunk) - first;
        for (long long j = a; j < b; ++j) acc += buf[j];
        if (next_r != r) {
            if (mine) out[static_cast<size_t>(r) * n + g] = acc;
            acc = 0.0f;
        }
        __syncthreads();         // the buffer is free for the stage after next
        if (!more) break;
        if (next_r != r) chunks = row_chunks(next_r);
        r = next_r;
        c = next_c;
        ++stage;
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
