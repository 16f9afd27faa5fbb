// SSIM, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves SSIM (langsplat_tpu/core/losses.py
// ssim) to XLA's depthwise convolutions. The port ran it as ~250 elementwise PyTorch
// launches forward (the 11-tap window as 11 shifted multiply-adds a pass, 2 passes a blur,
// 5 blurs) and ~280 in autograd's backward. Here one block takes one 32x32 output tile of
// one plane: the forward is one launch and a small fixed-order sum of its partials, the
// backward one launch.
//
// Contract (core/losses.py ssim_map_plain; planes are the batch and channel axes
// together, each [H, W] row-major):
//   forward:  img1, img2 [P, H, W], the window's taps w[0..2r] (r <= kHalo) -> the sum of
//             the SSIM map over each tile (`partials`, double) and their mean; the map
//             itself when asked (tests); and, when img1's gradient will be asked for,
//             three derivative maps [3, P, H, W]: dS/dmu1 with the sigma terms' chain
//             folded in, dS/dE[x^2] and dS/dE[xy];
//   backward: the incoming gradient g of the mean -> dL/dimg1 =
//             g/N * (B[dS/dmu1] + 2x * B[dS/dE[x^2]] + y * B[dS/dE[xy]]), where B is the
//             window's zero-padded blur, its own adjoint since the window is symmetric.
//
// Numbers. The source is built with --fmad=false (ops/_build.py), so every + and *
// rounds alone. A blur is the plain version's: the vertical pass, then the horizontal
// pass over the vertical pass's zero-padded result, each w0*v0 then + w_i*v_i in tap
// order, over the zero-padded halo (the padded taps add w*0 as the plain version's do).
// The map follows the plain version's expression in its order, so it is bit-equal to the
// plain version on the card. The mean differs from torch.mean by summation order only:
// each block sums its map in double in a fixed tree, one block sums the partials in a
// fixed order. No atomics: two runs give the same bits.
//
// What bounds it: device-memory bytes, barely; the ~530 launches it replaces did. At
// 1024x768x3 the forward reads 8 B and writes 12 B a pixel and channel, the backward
// reads 20 B and writes 4 B: ~104 MB, 0.03 ms at 3.35 TB/s; ~350 FP32 operations a pixel
// and channel forward (two IEEE divisions among them) and ~150 backward, ~0.02 ms at 67
// TFLOP/s. Design against it: each input word is read from device memory once a tile
// (the halo's 1.7x again from L2); every intermediate stays in shared memory or
// registers, and only the three derivative maps go back to device memory. A thread's
// vertical pass takes kRunV rows of one column and its horizontal pass kRunH columns of
// one row, so each shared-memory value it reads (and x^2, y^2, xy, formed once) feeds
// every output of its run in registers; rows of the vertical result are kPitch apart, so
// a warp's reads across 4 rows and 8 runs hit 32 banks; a run inside the image is one
// 16-byte load or store where the rows allow.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kTile = 32;                   // output tile: kTile x kTile pixels
constexpr int kHalo = 5;                    // the largest window radius
constexpr int kSpan = kTile + 2 * kHalo;    // a tile and its halo, either axis
constexpr int kPitch = kSpan + 1;           // a vertical-pass row in shared memory: odd,
                                            // so the horizontal pass's reads miss no bank
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRunV = 8;                    // vertical pass: rows a thread, one column
constexpr int kRunH = 4;                    // horizontal pass: columns a thread, one row
constexpr int kItemsV = kSpan * (kTile / kRunV);
static_assert(kTile * kTile == kThreads * kRunH, "one horizontal run a thread");

struct Taps {
    float w[2 * kHalo + 1];
};

struct Geometry {
    int h, w, tiles_x, tiles;   // tiles: a plane's
    long long plane, total;     // elements: a plane's, all planes'
    bool vec;                   // rows of 16-byte multiples, every image 16-byte aligned
};

// Tap k of output j from the run's i-th value (k = i - j): the first tap assigns, the
// others add, so each output is w0*v0 + w1*v1 + ... in tap order, as the plain
// version's shifted multiply-adds are.
template <int R>
__device__ __forceinline__ void tap(float& acc, int k, float v, const Taps& t) {
    if (k == 0) {
        acc = t.w[0] * v;
    } else if (k > 0 && k <= 2 * R) {
        acc = acc + t.w[k] * v;
    }
}

// Stage `count` maps of one plane's tile and halo into `dst` [count][kSpan][kSpan],
// zero outside the image.
template <int count>
__device__ __forceinline__ void stage(const float* const (&src)[count], const Geometry& g,
                                      int y0, int x0, float (*dst)[kSpan][kSpan]) {
    for (int i = threadIdx.x; i < kSpan * kSpan; i += kThreads) {
        const int r = i / kSpan, c = i - r * kSpan;
        const int gy = y0 - kHalo + r, gx = x0 - kHalo + c;
        const bool in = gy >= 0 && gy < g.h && gx >= 0 && gx < g.w;
        const long long at = static_cast<long long>(gy) * g.w + gx;
#pragma unroll
        for (int q = 0; q < count; ++q) dst[q][r][c] = in ? src[q][at] : 0.0f;
    }
}

// The horizontal pass of `count` vertical-pass maps for this thread's run of kRunH
// outputs of row `r`, starting at tile column `c0`.
template <int R, int count>
__device__ __forceinline__ void horizontal(float (*v)[kTile][kPitch], int r, int c0,
                                           const Taps& t, float (&out)[count][kRunH]) {
#pragma unroll
    for (int q = 0; q < count; ++q) {
#pragma unroll
        for (int i = 0; i < kRunH + 2 * R; ++i) {
            const float x = v[q][r][c0 + kHalo - R + i];
#pragma unroll
            for (int j = 0; j < kRunH; ++j) tap<R>(out[q][j], i - j, x, t);
        }
    }
}

// Where this thread's horizontal run lies: its tile row and first column, and the
// image's row and first column.
struct Run {
    int r, c0, gy, gx;
    __device__ Run(int y0, int x0)
        : r(threadIdx.x / (kTile / kRunH)), c0(threadIdx.x % (kTile / kRunH) * kRunH),
          gy(y0 + r), gx(x0 + c0) {}
};

// A run's kRunH values stored at `dst` (the run's first pixel): as one 16-byte store
// where the run lies inside the image and is 16-byte aligned (`vec`), else one at a time.
__device__ __forceinline__ void store_run(float* dst, const float (&v)[kRunH], int left,
                                          bool vec) {
    if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int j = 0; j < kRunH; ++j)
            if (j < left) dst[j] = v[j];
    }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
ssim_fwd_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
                Geometry g, Taps taps, float c1, float c2, double* __restrict__ partials,
                float* __restrict__ map_out, float* __restrict__ dmaps) {
    __shared__ float s_in[2][kSpan][kSpan];
    __shared__ float s_v[5][kTile][kPitch];   // vertical pass: mu1, mu2, E[x^2], E[y^2], E[xy]
    __shared__ double s_warp[kWarps];
    const int plane = blockIdx.y, tile = blockIdx.x;
    const int y0 = tile / g.tiles_x * kTile, x0 = tile % g.tiles_x * kTile;
    const long long base = plane * g.plane;
    const float* const src[2] = {img1 + base, img2 + base};
    stage<2>(src, g, y0, x0, s_in);
    __syncthreads();

    // vertical pass over every column of the halo: a thread takes kRunV rows of one
    // column, each input value read once and its squares and product formed once
    for (int item = threadIdx.x; item < kItemsV; item += kThreads) {
        const int c = item % kSpan, r0 = item / kSpan * kRunV;
        float acc[5][kRunV];
#pragma unroll
        for (int i = 0; i < kRunV + 2 * R; ++i) {
            const float x = s_in[0][r0 + kHalo - R + i][c];
            const float y = s_in[1][r0 + kHalo - R + i][c];
            const float v[5] = {x, y, x * x, y * y, x * y};
#pragma unroll
            for (int j = 0; j < kRunV; ++j) {
#pragma unroll
                for (int q = 0; q < 5; ++q) tap<R>(acc[q][j], i - j, v[q], taps);
            }
        }
#pragma unroll
        for (int q = 0; q < 5; ++q) {
#pragma unroll
            for (int j = 0; j < kRunV; ++j) s_v[q][r0 + j][c] = acc[q][j];
        }
    }
    __syncthreads();

    const Run run(y0, x0);
    float blurred[5][kRunH];
    horizontal<R, 5>(s_v, run.r, run.c0, taps, blurred);
    float map[kRunH], d_mu[kRunH], d_e11[kRunH], d_e12[kRunH];
    double sum = 0.0;
#pragma unroll
    for (int j = 0; j < kRunH; ++j) {
        const float mu1 = blurred[0][j], mu2 = blurred[1][j];
        // the plain version's expression, in its order
        const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
        const float sigma1_sq = blurred[2][j] - mu1_sq, sigma2_sq = blurred[3][j] - mu2_sq;
        const float sigma12 = blurred[4][j] - mu1_mu2;
        const float a1 = 2.0f * mu1_mu2 + c1, a2 = 2.0f * sigma12 + c2;
        const float b1 = mu1_sq + mu2_sq + c1, b2 = sigma1_sq + sigma2_sq + c2;
        const float den = b1 * b2;
        map[j] = (a1 * a2) / den;
        // the derivative maps, with one division: 1 / b2 = b1 / den
        const float two_inv = 2.0f / den;
        d_mu[j] = two_inv * (mu2 * (a2 - a1) - mu1 * map[j] * (b2 - b1));
        d_e11[j] = -0.5f * two_inv * b1 * map[j];
        d_e12[j] = two_inv * a1;
        if (run.gy < g.h && run.gx + j < g.w) sum += static_cast<double>(map[j]);
    }
    if (run.gy < g.h && run.gx < g.w) {
        const int left = g.w - run.gx;
        const bool vec = g.vec && left >= kRunH;
        const long long at = base + static_cast<long long>(run.gy) * g.w + run.gx;
        if (map_out != nullptr) store_run(map_out + at, map, left, vec);
        if (dmaps != nullptr) {
            store_run(dmaps + at, d_mu, left, vec);
            store_run(dmaps + g.total + at, d_e11, left, vec);
            store_run(dmaps + 2 * g.total + at, d_e12, left, vec);
        }
    }

    // the block's sum in a fixed order: each warp's by shuffles, then the warps' in turn
#pragma unroll
    for (int lane = 16; lane > 0; lane /= 2) sum += __shfl_down_sync(0xffffffffu, sum, lane);
    if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
        double total = s_warp[0];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) total += s_warp[w];
        partials[static_cast<long long>(plane) * g.tiles + tile] = total;
    }
}

// One block: the partials' sum in a fixed order, over the element count.
__global__ void __launch_bounds__(kThreads)
ssim_mean_kernel(const double* __restrict__ partials, long long count, long long numel,
                 float* __restrict__ mean) {
    __shared__ double s_sum[kThreads];
    double sum = 0.0;
    for (long long i = threadIdx.x; i < count; i += kThreads) sum += partials[i];
    s_sum[threadIdx.x] = sum;
    __syncthreads();
    for (int half = kThreads / 2; half > 0; half /= 2) {
        if (threadIdx.x < half) s_sum[threadIdx.x] += s_sum[threadIdx.x + half];
        __syncthreads();
    }
    if (threadIdx.x == 0) mean[0] = static_cast<float>(s_sum[0] / static_cast<double>(numel));
}

template <int R>
__global__ void __launch_bounds__(kThreads)
ssim_bwd_kernel(const float* __restrict__ img1, const float* __restrict__ img2,
                const float* __restrict__ dmaps, Geometry g, Taps taps,
                const float* __restrict__ grad_out, float* __restrict__ grad1) {
    __shared__ float s_in[3][kSpan][kSpan];
    __shared__ float s_v[3][kTile][kPitch];
    const int plane = blockIdx.y, tile = blockIdx.x;
    const int y0 = tile / g.tiles_x * kTile, x0 = tile % g.tiles_x * kTile;
    const long long base = plane * g.plane;
    const float* const src[3] = {dmaps + base, dmaps + g.total + base,
                                 dmaps + 2 * g.total + base};
    stage<3>(src, g, y0, x0, s_in);
    __syncthreads();

    for (int item = threadIdx.x; item < kItemsV; item += kThreads) {
        const int c = item % kSpan, r0 = item / kSpan * kRunV;
        float acc[3][kRunV];
#pragma unroll
        for (int i = 0; i < kRunV + 2 * R; ++i) {
#pragma unroll
            for (int q = 0; q < 3; ++q) {
                const float v = s_in[q][r0 + kHalo - R + i][c];
#pragma unroll
                for (int j = 0; j < kRunV; ++j) tap<R>(acc[q][j], i - j, v, taps);
            }
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) {
#pragma unroll
            for (int j = 0; j < kRunV; ++j) s_v[q][r0 + j][c] = acc[q][j];
        }
    }
    __syncthreads();

    const Run run(y0, x0);
    if (run.gy >= g.h || run.gx >= g.w) return;
    float blurred[3][kRunH];
    horizontal<R, 3>(s_v, run.r, run.c0, taps, blurred);
    const float scale =
        static_cast<float>(static_cast<double>(grad_out[0]) / static_cast<double>(g.total));
    const int left = g.w - run.gx;
    const bool vec = g.vec && left >= kRunH;
    const long long at = base + static_cast<long long>(run.gy) * g.w + run.gx;
    float x[kRunH], y[kRunH], grad[kRunH];
    if (vec) {
        const float4 xv = *reinterpret_cast<const float4*>(img1 + at);
        const float4 yv = *reinterpret_cast<const float4*>(img2 + at);
        x[0] = xv.x, x[1] = xv.y, x[2] = xv.z, x[3] = xv.w;
        y[0] = yv.x, y[1] = yv.y, y[2] = yv.z, y[3] = yv.w;
    } else {
#pragma unroll
        for (int j = 0; j < kRunH; ++j) {
            x[j] = j < left ? img1[at + j] : 0.0f;
            y[j] = j < left ? img2[at + j] : 0.0f;
        }
    }
#pragma unroll
    for (int j = 0; j < kRunH; ++j)
        grad[j] = scale * (blurred[0][j] + 2.0f * x[j] * blurred[1][j] + y[j] * blurred[2][j]);
    store_run(grad1 + at, grad, left, vec);
}

// `images`: the pointers the kernels read or write a run of at a time
Geometry geometry(int planes, int h, int w, std::initializer_list<const void*> images = {}) {
    const int tiles_x = (w + kTile - 1) / kTile, tiles_y = (h + kTile - 1) / kTile;
    const long long plane = static_cast<long long>(h) * w;
    bool vec = w % 4 == 0;
    for (const void* p : images)
        vec = vec && reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
    return Geometry{h, w, tiles_x, tiles_x * tiles_y, plane, plane * planes, vec};
}

bool valid(int planes, int h, int w, int radius) {
    return planes > 0 && planes <= 65535 && h > 0 && w > 0 && radius >= 0 &&
           radius <= kHalo;
}

Taps make_taps(const float* taps, int radius) {
    Taps t{};
    for (int k = 0; k <= 2 * radius; ++k) t.w[k] = taps[k];
    return t;
}

}  // namespace

// The partial sums `ssim_fwd` writes: one a tile of each plane.
extern "C" long long ssim_partials(int planes, int h, int w) {
    return static_cast<long long>(geometry(planes, h, w).tiles) * planes;
}

extern "C" int ssim_fwd(const void* img1, const void* img2, int planes, int h, int w,
                        const float* taps, int radius, float c1, float c2, void* partials,
                        void* mean, void* map_out, void* dmaps, void* stream) {
    if (!valid(planes, h, w, radius)) return static_cast<int>(cudaErrorInvalidValue);
    const Geometry g = geometry(planes, h, w, {map_out, dmaps});
    const Taps t = make_taps(taps, radius);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid(g.tiles, planes);
    auto* part = static_cast<double*>(partials);
    const auto* a = static_cast<const float*>(img1);
    const auto* b = static_cast<const float*>(img2);
    auto* m = static_cast<float*>(map_out);
    auto* d = static_cast<float*>(dmaps);
#define FWD(R) ssim_fwd_kernel<R><<<grid, kThreads, 0, s>>>(a, b, g, t, c1, c2, part, m, d)
    switch (radius) {
        case 0: FWD(0); break;
        case 1: FWD(1); break;
        case 2: FWD(2); break;
        case 3: FWD(3); break;
        case 4: FWD(4); break;
        default: FWD(5); break;
    }
#undef FWD
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ssim_mean_kernel<<<1, kThreads, 0, s>>>(part, static_cast<long long>(g.tiles) * planes,
                                            g.total, static_cast<float*>(mean));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ssim_bwd(const void* img1, const void* img2, const void* dmaps, int planes,
                        int h, int w, const float* taps, int radius, const void* grad_out,
                        void* grad1, void* stream) {
    if (!valid(planes, h, w, radius)) return static_cast<int>(cudaErrorInvalidValue);
    const Geometry g = geometry(planes, h, w, {img1, img2, grad1});
    const Taps t = make_taps(taps, radius);
    auto s = static_cast<cudaStream_t>(stream);
    const dim3 grid(g.tiles, planes);
    const auto* a = static_cast<const float*>(img1);
    const auto* b = static_cast<const float*>(img2);
    const auto* d = static_cast<const float*>(dmaps);
    const auto* go = static_cast<const float*>(grad_out);
    auto* out = static_cast<float*>(grad1);
#define BWD(R) ssim_bwd_kernel<R><<<grid, kThreads, 0, s>>>(a, b, d, g, t, go, out)
    switch (radius) {
        case 0: BWD(0); break;
        case 1: BWD(1); break;
        case 2: BWD(2); break;
        case 3: BWD(3); break;
        case 4: BWD(4); break;
        default: BWD(5); break;
    }
#undef BWD
    return static_cast<int>(cudaGetLastError());
}
