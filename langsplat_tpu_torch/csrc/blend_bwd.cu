// Blend backward of the tile rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel langsplat_tpu/ops/rasterize_pallas.py::_bwd_kernel (:746),
// launched there by _bwd_call (:1156) from blend_tiles' VJP _blend_bwd (:1224). Same
// contract: for every instance i of a tile and every pixel it was blended into, with
// the forward's weight w_i = alpha_i T_i,
//   gdot_i   = sum_ch g_ch attr_ch,i                 (attr = RGB, then features)
//   S_i      = sum_{j>i} w_j gdot_j + g_T T_final     = (Total - Prefix_i) + g_T T_final
//   dalpha_i = T_i gdot_i - S_i / (1 - alpha_i)
// with Total = sum_ch g_ch out_ch (the forward's image without the background) and
// Prefix_i = sum_{j<=i} w_j gdot_j, so one front-to-back replay gives every suffix sum
// (rasterize_pallas.py:22-27, :933-951). Through alpha = min(0.99, opa exp(power)) (no
// gradient where the clamp holds) and power = -0.5 (a dx^2 + c dy^2) - b dx dy, each
// instance gets d mean2d (x, y), d conic (a, b, c), d opacity and d attr = g_ch w,
// summed over the tile's pixels. grad_mode "feature" computes only d features.
//
// What bounds it on this card: the per-(instance, pixel) arithmetic of the replay
// (the forward's ~17 FP32 operations and one expf per evaluated pair, ~40 + 3C more per
// blended pair) and the per-instance reduction of 9 + F sums over the tile's 256
// pixels. Device-memory traffic is small: the instance attributes are read once per
// tile, the per-pixel gradients once, and each instance's 9 + F sums written once.
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel, instances in
// batches of 256 gathered straight from the per-Gaussian arrays into shared memory, as
// in blend_fwd.cu, whose falloff/alpha/transmittance arithmetic (blend_common.cuh) the
// replay shares, so it includes exactly the pairs the forward blended. Each thread
// carries T and Prefix. The per-instance sums are reduced in a fixed order, so the
// result is bitwise deterministic and no atomics are used: a butterfly of warp shuffles
// gives each warp's partial (skipped, as exact zeros, when no lane of the warp blended
// the instance); the 8 warp partials of 32 consecutive instances are staged in shared
// memory and summed in warp order after one barrier. The sums go to column
// presort_slot[i] of d_pre [R, budget] (R = 9 + F, or F in feature mode), the
// Gaussian-major slot order in which segsum.cu reduces them per Gaussian. Instances a
// tile never reached (every pixel ended earlier) are not written: the caller zeroes
// d_pre. fp32 throughout, no fast-math.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using blend::kAlphaEps;
using blend::kAlphaMax;
using blend::kBlock;
using blend::kTermEps;
using blend::kTile;

constexpr int kWarps = kBlock / 32;
constexpr int kSub = 32;   // instances per reduction stage
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_down_sync(kFull, x, offset);
    return x;   // lane 0 holds the warp's sum
}

template <int F, bool FEATURE_ONLY>
__global__ void __launch_bounds__(kBlock)
blend_bwd_kernel(const float* __restrict__ means2d,     // [N, 2]
                 const float* __restrict__ conics,      // [N, 3] (a, b, c)
                 const float* __restrict__ opacities,   // [N]
                 const bool* __restrict__ visible,      // [N]
                 const float* __restrict__ colors,      // [N, 3]
                 const float* __restrict__ features,    // [N, F]
                 const int* __restrict__ gauss_id,      // [budget], sorted by (tile, depth)
                 const int* __restrict__ tile_start,    // [num_tiles + 1]
                 const int* __restrict__ presort_slot,  // [budget]
                 const float* __restrict__ g_image,     // [3 + F, H, W]
                 const float* __restrict__ g_tfinal,    // [H, W], background term included
                 const float* __restrict__ total,       // [H, W]
                 const float* __restrict__ t_final,     // [H, W]
                 int height, int width, int grid_x, int budget,
                 float* __restrict__ d_pre,             // [R, budget], zeroed by the caller
                 float* __restrict__ t_replay)          // [H, W] or null
{
    constexpr int C = 3 + F;
    constexpr int R = FEATURE_ONLY ? F : 9 + F;
    constexpr int NA = FEATURE_ONLY ? 1 : C;   // attribute rows gdot needs
    __shared__ float2 s_mean[kBlock];
    __shared__ float4 s_conic_opa[kBlock];
    __shared__ float s_attr[NA][kBlock];
    __shared__ int s_slot[kBlock];
    __shared__ float s_part[kWarps][R][kSub];

    const int tile = blockIdx.x;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int px = (tile % grid_x) * kTile + threadIdx.x % kTile;
    const int py = (tile / grid_x) * kTile + threadIdx.x / kTile;
    const bool inside = px < width && py < height;
    const float fx = static_cast<float>(px);
    const float fy = static_cast<float>(py);
    const int start = tile_start[tile];
    const int end = tile_start[tile + 1];
    const int hw = height * width;
    const int p = py * width + px;

    float g[C];
#pragma unroll
    for (int c = 0; c < C; ++c) g[c] = inside ? g_image[c * hw + p] : 0.0f;
    const float tot = inside ? total[p] : 0.0f;
    const float tail = inside ? g_tfinal[p] * t_final[p] : 0.0f;

    float T = 1.0f;
    float prefix = 0.0f;
    bool done = !inside;

    for (int base = start; base < end; base += kBlock) {
        // every thread has finished the previous batch here; the block leaves once
        // all of its pixels are done (the instances left unwritten keep zero)
        if (__syncthreads_count(done) == kBlock) break;
        const int i = base + threadIdx.x;
        if (i < end) {
            const int gi = gauss_id[i];
            s_mean[threadIdx.x] = make_float2(means2d[2 * gi], means2d[2 * gi + 1]);
            s_conic_opa[threadIdx.x] = make_float4(
                conics[3 * gi], conics[3 * gi + 1], conics[3 * gi + 2],
                visible[gi] ? opacities[gi] : 0.0f);
            if constexpr (!FEATURE_ONLY) {
#pragma unroll
                for (int c = 0; c < 3; ++c) s_attr[c][threadIdx.x] = colors[3 * gi + c];
#pragma unroll
                for (int f = 0; f < F; ++f) s_attr[3 + f][threadIdx.x] = features[F * gi + f];
            }
            s_slot[threadIdx.x] = presort_slot[i];
        }
        __syncthreads();
        const int count = min(kBlock, end - base);
        for (int k0 = 0; k0 < count; k0 += kSub) {
            const int kn = min(kSub, count - k0);
            for (int j = 0; j < kn; ++j) {
                const int k = k0 + j;
                float v[R];
#pragma unroll
                for (int r = 0; r < R; ++r) v[r] = 0.0f;
                bool live = false;
                if (!done) {
                    const float2 m = s_mean[k];
                    const float4 co = s_conic_opa[k];
                    const float dx = fx - m.x;
                    const float dy = fy - m.y;
                    const float power = blend::falloff_power(dx, dy, co.x, co.y, co.z);
                    if (!(power > 0.0f)) {   // the forward's tests, NaN included
                        const float gexp = expf(power);
                        const float raw = blend::raw_alpha(co.w, gexp);
                        const float alpha = fminf(kAlphaMax, raw);
                        if (!(alpha < kAlphaEps)) {
                            const float test_t = blend::next_transmittance(T, alpha);
                            if (test_t < kTermEps) {
                                done = true;
                            } else {
                                live = true;
                                const float w = alpha * T;
                                if constexpr (FEATURE_ONLY) {
#pragma unroll
                                    for (int f = 0; f < F; ++f) v[f] = g[3 + f] * w;
                                } else {
                                    float gdot = 0.0f;
#pragma unroll
                                    for (int c = 0; c < C; ++c)
                                        gdot += g[c] * s_attr[c][k];
                                    prefix += w * gdot;
                                    const float suffix = (tot - prefix) + tail;
                                    const float dalpha = T * gdot - suffix / (1.0f - alpha);
                                    const float dag = raw < kAlphaMax ? dalpha : 0.0f;
                                    const float dpower = dag * alpha;
                                    v[0] = dpower * (co.x * dx + co.y * dy);   // d mean x
                                    v[1] = dpower * (co.z * dy + co.y * dx);   // d mean y
                                    v[2] = -0.5f * dpower * dx * dx;           // d conic a
                                    v[3] = -dpower * dx * dy;                  // d conic b
                                    v[4] = -0.5f * dpower * dy * dy;           // d conic c
                                    v[5] = dag * gexp;                         // d opacity
#pragma unroll
                                    for (int c = 0; c < C; ++c) v[6 + c] = g[c] * w;
                                }
                                T = test_t;
                            }
                        }
                    }
                }
                if (__any_sync(kFull, live)) {
#pragma unroll
                    for (int r = 0; r < R; ++r) v[r] = warp_sum(v[r]);
                }
                if (lane == 0) {
#pragma unroll
                    for (int r = 0; r < R; ++r) s_part[warp][r][j] = v[r];
                }
            }
            __syncthreads();
            for (int q = threadIdx.x; q < R * kn; q += kBlock) {
                const int r = q / kn;
                const int j = q % kn;
                float s = 0.0f;
#pragma unroll
                for (int w = 0; w < kWarps; ++w) s += s_part[w][r][j];
                const int slot = s_slot[k0 + j];
                if (slot < budget) d_pre[static_cast<size_t>(r) * budget + slot] = s;
            }
            __syncthreads();
        }
    }

    if (inside && t_replay != nullptr) t_replay[p] = T;
}

template <int F, bool FEATURE_ONLY>
int launch(const void* means2d, const void* conics, const void* opacities,
           const void* visible, const void* colors, const void* features,
           const void* gauss_id, const void* tile_start, const void* presort_slot,
           const void* g_image, const void* g_tfinal, const void* total,
           const void* t_final, int height, int width, int grid_x, int num_tiles,
           int budget, void* d_pre, void* t_replay, cudaStream_t stream) {
    blend_bwd_kernel<F, FEATURE_ONLY><<<num_tiles, kBlock, 0, stream>>>(
        static_cast<const float*>(means2d), static_cast<const float*>(conics),
        static_cast<const float*>(opacities), static_cast<const bool*>(visible),
        static_cast<const float*>(colors), static_cast<const float*>(features),
        static_cast<const int*>(gauss_id), static_cast<const int*>(tile_start),
        static_cast<const int*>(presort_slot), static_cast<const float*>(g_image),
        static_cast<const float*>(g_tfinal), static_cast<const float*>(total),
        static_cast<const float*>(t_final), height, width, grid_x, budget,
        static_cast<float*>(d_pre), static_cast<float*>(t_replay));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point for ctypes. Returns cudaGetLastError() after the launch (0 = success);
// an unsupported feature count (or feature mode without features) returns
// cudaErrorInvalidValue without launching. t_replay may be null.
extern "C" int blend_bwd(const void* means2d, const void* conics, const void* opacities,
                         const void* visible, const void* colors, const void* features,
                         const void* gauss_id, const void* tile_start,
                         const void* presort_slot, const void* g_image,
                         const void* g_tfinal, const void* total, const void* t_final,
                         int num_feat, int feature_only, int height, int width,
                         int grid_x, int num_tiles, int budget, void* d_pre,
                         void* t_replay, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLEND_BWD_CASE(F, MODE)                                                        \
    case F:                                                                            \
        return launch<F, MODE>(means2d, conics, opacities, visible, colors, features,  \
                               gauss_id, tile_start, presort_slot, g_image, g_tfinal,  \
                               total, t_final, height, width, grid_x, num_tiles,       \
                               budget, d_pre, t_replay, s);
    if (feature_only) {
        switch (num_feat) {
            BLEND_BWD_CASE(1, true)
            BLEND_BWD_CASE(2, true)
            BLEND_BWD_CASE(3, true)
            BLEND_BWD_CASE(4, true)
            BLEND_BWD_CASE(5, true)
            BLEND_BWD_CASE(6, true)
            BLEND_BWD_CASE(7, true)
            BLEND_BWD_CASE(8, true)
            default:
                return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    switch (num_feat) {
        BLEND_BWD_CASE(0, false)
        BLEND_BWD_CASE(1, false)
        BLEND_BWD_CASE(2, false)
        BLEND_BWD_CASE(3, false)
        BLEND_BWD_CASE(4, false)
        BLEND_BWD_CASE(5, false)
        BLEND_BWD_CASE(6, false)
        BLEND_BWD_CASE(7, false)
        BLEND_BWD_CASE(8, false)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef BLEND_BWD_CASE
}
