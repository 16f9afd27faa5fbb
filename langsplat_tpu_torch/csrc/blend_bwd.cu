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
// What bounds it on this card: issue slots. The per-(instance, pixel) arithmetic of the
// replay (the forward's ~17 FP32 operations and one expf per pair a warp evaluates,
// ~40 + 3C more per blended pair) and the per-instance reduction of 9 + F sums over the
// tile's pixels, whose warp shuffles issue at a quarter of the FP32 rate. With the cull
// (below), a warp evaluates the instances that can reach its pixels, so the work follows
// the blended pairs rather than every pair of the binned tiles. Device-memory traffic
// is small: the instance attributes are read once per tile, the per-pixel gradients
// once, and each kept instance's 9 + F sums written once.
//
// Design: one block of 256 threads per 16x16 tile, one thread per pixel, each warp on
// an 8x4 block of pixels (its region), instances in batches of 256 gathered straight
// from the per-Gaussian arrays into shared memory, as in blend_fwd.cu, whose
// falloff/alpha/transmittance arithmetic (blend_common.cuh) the replay shares, so it
// includes exactly the pairs the forward blended.
//
// Cull: the forward's, from blend_common.cuh (stage_batch, which both kernels call).
// When a batch is staged, the block tests each instance against the tile and against
// each warp's region (the box minimum of the conic quadratic against ln(opacity * 255),
// with a rounding margin), and a warp walks only the instances it kept; the attributes
// and slot of an instance no warp keeps are not gathered. Every pair skipped has
// alpha < 1/255, so the per-pixel test still decides every pair the kernel keeps, the
// replayed final T equals the forward's bit for bit, and no pair that blends is
// skipped. The training path bins Gaussians uncut once their tile rect passes the
// culled tile cap, and after an opacity reset the alpha >= 1/255 ellipse is small next
// to the tiles kept: there most (instance, warp) pairs are skipped.
//
// Each thread carries T and Prefix. The per-instance sums are reduced in a fixed order,
// so the result is bitwise deterministic and no atomics are used. A warp walks the
// instances it kept in groups of G = 18 / R (2 for R = 9, 1 for R = 12, 6 for R = 3),
// each lane holding the group's R x G values, and one transposed reduce-scatter of 31
// shuffles (reduce_scatter below) leaves the warp's partial of one (row, instance) of
// the group in each lane, against 5 shuffles per row and instance for a butterfly per
// value; it pairs the lanes as the butterfly did, so the sums are the same bits. A
// group in which no lane blended is skipped (exact zeros). Larger groups (G = 32 / R)
// take fewer shuffles but spill registers at the 64 that keep 4 blocks on an SM
// (see kMinBlocks). The
// partials of the warps that kept each of 32 consecutive instances are staged in shared
// memory and summed in warp order after one barrier. The sums go to column
// presort_slot[i] of d_pre [R, budget] (R = 9 + F, or F in feature mode), the
// Gaussian-major slot order in which segsum.cu reduces them per Gaussian. Instances a
// tile never reached (every pixel ended earlier) or that no warp kept are not written:
// the caller zeroes d_pre. fp32 throughout, no fast-math.
//
// Tried on the training fields and left out, both slower (PERF.md §6): rejecting a
// pixel's pair before expf where its power is below -lambda by the margin, and gathering
// the next batch with cp.async into a second buffer (more registers and shared memory,
// fewer blocks on an SM).

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using blend::kAlphaEps;
using blend::kAlphaMax;
using blend::kBlock;
using blend::kFull;
using blend::kRegionH;
using blend::kRegionW;
using blend::kTermEps;
using blend::kTile;
using blend::kWarps;
using blend::MaskScratch;
using blend::stage_batch;

constexpr int kSub = 32;      // instances per reduction stage

// One halving step of the transposed reduce-scatter, then the next: lanes with bit H
// clear keep values [0, H) and send [H, 2H) to their partner (lane ^ H), the others the
// reverse, each adding what it receives. Template steps keep every index a constant,
// so the values stay in registers.
template <int H>
__device__ __forceinline__ void reduce_scatter_step(float (&w)[32], int lane) {
    const bool upper = (lane & H) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const float send = upper ? w[i] : w[i + H];
        const float keep = upper ? w[i + H] : w[i];
        w[i] = keep + __shfl_xor_sync(kFull, send, H);
    }
    if constexpr (H > 1) reduce_scatter_step<H / 2>(w, lane);
}

// Reduce V <= 32 values per lane (zero-padded to 32) over the warp: 16 + 8 + 4 + 2 + 1 =
// 31 shuffles, after which lane l holds the warp's sum of value l. The pairing is fixed
// (bit 4 of the lane first, as a shfl_down butterfly pairs them), so the sums are
// bitwise deterministic.
template <int V>
__device__ __forceinline__ float reduce_scatter(const float (&v)[V], int lane) {
    static_assert(V <= 32, "at most 32 values a lane");
    float w[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) w[i] = i < V ? v[i] : 0.0f;
    reduce_scatter_step<16>(w, lane);
    return w[0];
}

// Blocks of 256 threads an SM must hold: 4 (64 registers a thread, which the kernel
// fits without spills for R <= 12), 2 for the wider rows (R > 12: F >= 4 in full mode),
// which would spill at 64. With min-blocks 1 ptxas takes ~72 registers (3 blocks an
// SM), ~10% slower on the training fields. Groups of 32 / R with no min-blocks gave 64
// registers and 8-48 bytes of spills, and ran 3-5% faster than this build there
// (PERF.md §6); this build gives that up to keep to no spills.
template <int F, bool FEATURE_ONLY>
constexpr int kMinBlocks = (FEATURE_ONLY ? F : 9 + F) > 12 ? 2 : 4;

template <int F, bool FEATURE_ONLY>
__global__ void __launch_bounds__(kBlock, kMinBlocks<F, FEATURE_ONLY>)
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
    constexpr int G = R >= 18 ? 1 : 18 / R;    // instances a reduce-scatter takes
    constexpr int V = R * G;                   // values a lane holds for it (<= 18)
    __shared__ float2 s_mean[kBlock];
    __shared__ float4 s_conic_opa[kBlock];
    __shared__ float s_attr[NA][kBlock];
    __shared__ int s_slot[kBlock];
    __shared__ unsigned char s_mask[kBlock];
    __shared__ MaskScratch s_scratch;
    __shared__ float s_part[kWarps][kSub][R];

    const int tile = blockIdx.x;
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int tx0 = (tile % grid_x) * kTile;
    const int ty0 = (tile / grid_x) * kTile;
    const int px = tx0 + (warp % 2) * kRegionW + lane % kRegionW;
    const int py = ty0 + (warp / 2) * kRegionH + lane / kRegionW;
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
        // the batch's positions, conics and masks; each thread gathers its instance's
        // attributes and slot where the instance may get a bit
        stage_batch(base, end, tx0, ty0, gauss_id, means2d, conics, opacities, visible,
                    s_mean, s_conic_opa, s_mask, s_scratch, [&](int gi, int i) {
                        if constexpr (!FEATURE_ONLY) {
#pragma unroll
                            for (int c = 0; c < 3; ++c)
                                s_attr[c][threadIdx.x] = colors[3 * gi + c];
#pragma unroll
                            for (int f = 0; f < F; ++f)
                                s_attr[3 + f][threadIdx.x] = features[F * gi + f];
                        }
                        s_slot[threadIdx.x] = presort_slot[i];
                    });
        const int count = min(kBlock, end - base);
        for (int k0 = 0; k0 < count; k0 += kSub) {
            const int kn = min(kSub, count - k0);
            // the instances of this stage the warp kept, in depth order, G at a time
            unsigned todo = __ballot_sync(
                kFull, lane < kn && ((s_mask[k0 + lane] >> warp) & 1u) != 0u);
            while (todo != 0u) {
                int jg[G];
#pragma unroll
                for (int q = 0; q < G; ++q) {
                    jg[q] = todo != 0u ? __ffs(static_cast<int>(todo)) - 1 : -1;
                    todo &= todo - 1u;
                }
                float v[V];
#pragma unroll
                for (int q = 0; q < V; ++q) v[q] = 0.0f;
                bool live = false;
#pragma unroll
                for (int q = 0; q < G; ++q) {
                    if (jg[q] < 0 || done) continue;
                    const int k = k0 + jg[q];
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
                                    for (int f = 0; f < F; ++f) v[q * R + f] = g[3 + f] * w;
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
                                    v[q * R + 0] = dpower * (co.x * dx + co.y * dy);   // d mean x
                                    v[q * R + 1] = dpower * (co.z * dy + co.y * dx);   // d mean y
                                    v[q * R + 2] = -0.5f * dpower * dx * dx;           // d conic a
                                    v[q * R + 3] = -dpower * dx * dy;                  // d conic b
                                    v[q * R + 4] = -0.5f * dpower * dy * dy;           // d conic c
                                    v[q * R + 5] = dag * gexp;                         // d opacity
#pragma unroll
                                    for (int c = 0; c < C; ++c) v[q * R + 6 + c] = g[c] * w;
                                }
                                T = test_t;
                            }
                        }
                    }
                }
                // lane l < V gets the warp's sum of value l: row l % R of the group's
                // instance l / R (exact zeros when no lane blended the group)
                const float sum = __any_sync(kFull, live) ? reduce_scatter<V>(v, lane) : 0.0f;
                if (lane < V) {
                    const int q = lane / R;
                    int j = jg[0];
#pragma unroll
                    for (int qq = 1; qq < G; ++qq)
                        if (q == qq) j = jg[qq];
                    if (j >= 0) s_part[warp][j][lane - q * R] = sum;
                }
            }
            __syncthreads();
            // each instance's sum over the warps that kept it, in warp order
            for (int q = threadIdx.x; q < R * kn; q += kBlock) {
                const int j = q / R;
                const int r = q % R;
                const unsigned mask = s_mask[k0 + j];
                if (mask == 0u) continue;
                float s = 0.0f;
#pragma unroll
                for (int w = 0; w < kWarps; ++w)
                    if ((mask >> w) & 1u) s += s_part[w][j][r];
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
