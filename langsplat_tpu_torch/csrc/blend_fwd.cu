// Blend forward of the tile rasterizer, for Hopper (sm_90a).
//
// Replaces the TPU kernel langsplat_tpu/ops/rasterize_pallas.py::_fwd_kernel (:597),
// launched there by _fwd_call (:1124) under blend_tiles. Same contract: for each 16x16
// tile, front to back over the tile's depth-sorted instances,
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy      (skip the instance if power > 0)
//   alpha = min(0.99, opacity * exp(power))       (skip it if alpha < 1/255)
//   test_T = T (1 - alpha); if test_T < 1e-4 the pixel ends and this instance is
//   excluded; otherwise C += alpha T (RGB, features) and T = test_T.
// Pixels sit at integer coordinates (no +0.5). The background is added to RGB only.
//
// What bounds it on this card: issue slots, spent on the per-(instance, pixel)
// arithmetic (about 17 + 2C FP32 operations and one expf per pair that is evaluated,
// C = 3 + F channels) and on deciding which pairs to evaluate. The work the function
// needs follows the pairs that blend, but binning lists every tile of a Gaussian's rect
// once the rect passes the culled tile cap (the training path), and after an opacity
// reset the alpha >= 1/255 ellipse covers a small part of them: evaluating every pair
// of every listed instance there spends ten falloffs for each pair that blends.
// Device-memory traffic is small: each instance's 9 + F attributes are fetched once per
// tile and the image is written once.
//
// The cull: blend_common.cuh's stage_batch, which the backward calls too (one logf,
// and box minima of the conic against ln(opacity * 255) with a proven rounding margin).
// Each warp owns an 8x4 region of the tile. When a batch of instances is staged, the
// block tests each instance against the tile, then the instances that pass against the
// eight regions, spread over the block one test a thread, and gives each instance an
// 8-bit mask. A warp then walks only the instances whose bit it holds, 32 at a time by
// a ballot over the masks, in depth order. Every pair the cull skips has alpha < 1/255,
// which the per-pixel test would skip as well, so each pixel blends the same pairs in
// the same order as without the cull. The falloff, alpha and transmittance arithmetic
// comes from blend_common.cuh, which the backward (blend_bwd.cu) shares, so the
// backward's replay includes exactly the pairs blended here and reaches the same final
// transmittance bit for bit.
//
// Design: one block of 256 threads per tile, one thread per pixel, warp w on columns
// (w % 2) * 8 .. + 7 and rows (w / 2) * 4 .. + 3. The block walks gauss_id[tile_start[t]
// : tile_start[t+1]] in batches of 256; each thread gathers one instance's position,
// conic and opacity straight from the per-Gaussian arrays into shared memory (no packed
// per-instance buffer is built, unlike the TPU path's pack_instances), and gathers its
// colors and features only where the cull may give it a bit. The per-pixel tests of a
// pair are predicates, not branches. A warp whose pixels are all done stops evaluating;
// the block leaves as soon as all of its pixels are done (__syncthreads_count). Results
// go channel-major straight into [3 + F, H, W] and [H, W], with the ragged image edge
// masked. fp32 throughout, expf (not __expf), no fast-math.
//
// Measured on the training fields and left out (PERF.md §6): the region tests inside
// each staging thread (a warp then runs them whenever one of its instances passes the
// tile: slower), a minimum of 5 or 6 blocks per SM (no faster; 6 spills), and batches
// of 512 instances (a few percent faster, but the F = 3 build spills).

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
using blend::MaskScratch;
using blend::stage_batch;

template <int F>
__global__ void __launch_bounds__(kBlock)
blend_fwd_kernel(const float* __restrict__ means2d,    // [N, 2]
                 const float* __restrict__ conics,     // [N, 3] (a, b, c)
                 const float* __restrict__ opacities,  // [N]
                 const bool* __restrict__ visible,     // [N]
                 const float* __restrict__ colors,     // [N, 3]
                 const float* __restrict__ features,   // [N, F]
                 const int* __restrict__ gauss_id,     // [budget], sorted by (tile, depth)
                 const int* __restrict__ tile_start,   // [num_tiles + 1]
                 const float* __restrict__ bg,         // [3]
                 int height, int width, int grid_x,
                 float* __restrict__ image,            // [3 + F, H, W]
                 float* __restrict__ t_final)          // [H, W]
{
    constexpr int C = 3 + F;
    __shared__ float2 s_mean[kBlock];
    __shared__ float4 s_conic_opa[kBlock];
    __shared__ float s_attr[C][kBlock];
    __shared__ unsigned char s_mask[kBlock];
    __shared__ MaskScratch s_scratch;

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

    float T = 1.0f;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    bool done = !inside;

    for (int base = start; base < end; base += kBlock) {
        // every thread has finished the previous batch here, so shared memory may be
        // overwritten; the block leaves once all of its pixels are done
        if (__syncthreads_count(done) == kBlock) break;
        // the batch's positions, conics and masks; each thread gathers its instance's
        // colors and features where the instance may get a bit
        stage_batch(base, end, tx0, ty0, gauss_id, means2d, conics, opacities, visible,
                    s_mean, s_conic_opa, s_mask, s_scratch, [&](int g, int) {
#pragma unroll
                        for (int c = 0; c < 3; ++c)
                            s_attr[c][threadIdx.x] = colors[3 * g + c];
#pragma unroll
                        for (int f = 0; f < F; ++f)
                            s_attr[3 + f][threadIdx.x] = features[F * g + f];
                    });
        const int count = min(kBlock, end - base);
        // the instances of the batch this warp kept, 32 at a time, in depth order
        for (int k0 = 0; k0 < count; k0 += 32) {
            if (__all_sync(kFull, done)) break;
            unsigned todo = __ballot_sync(
                kFull, k0 + lane < count && ((s_mask[k0 + lane] >> warp) & 1u) != 0u);
            while (todo != 0u) {
                const int k = k0 + __ffs(static_cast<int>(todo)) - 1;
                todo &= todo - 1u;
                const float2 m = s_mean[k];
                const float4 co = s_conic_opa[k];
                const float dx = fx - m.x;
                const float dy = fy - m.y;
                const float power = blend::falloff_power(dx, dy, co.x, co.y, co.z);
                const float alpha = fminf(kAlphaMax, blend::raw_alpha(co.w, expf(power)));
                // the per-pixel tests as predicates, not branches: a pixel that is done,
                // a positive power or alpha < 1/255 leaves the pixel as it is (a NaN
                // power fails no test, as in the backward's replay)
                const bool ok = !done && !(power > 0.0f) && !(alpha < kAlphaEps);
                const float test_t = blend::next_transmittance(T, alpha);
                const bool ends = test_t < kTermEps;
                done = done || (ok && ends);
                if (ok && !ends) {
                    const float w = alpha * T;
#pragma unroll
                    for (int c = 0; c < C; ++c) acc[c] += w * s_attr[c][k];
                    T = test_t;
                }
            }
        }
    }

    if (inside) {
        const int hw = height * width;
        const int p = py * width + px;
#pragma unroll
        for (int c = 0; c < 3; ++c) image[c * hw + p] = acc[c] + T * bg[c];
#pragma unroll
        for (int c = 3; c < C; ++c) image[c * hw + p] = acc[c];
        t_final[p] = T;
    }
}

template <int F>
int launch(const void* means2d, const void* conics, const void* opacities,
           const void* visible, const void* colors, const void* features,
           const void* gauss_id, const void* tile_start, const void* bg,
           int height, int width, int grid_x, int num_tiles,
           void* image, void* t_final, cudaStream_t stream) {
    blend_fwd_kernel<F><<<num_tiles, kBlock, 0, stream>>>(
        static_cast<const float*>(means2d), static_cast<const float*>(conics),
        static_cast<const float*>(opacities), static_cast<const bool*>(visible),
        static_cast<const float*>(colors), static_cast<const float*>(features),
        static_cast<const int*>(gauss_id), static_cast<const int*>(tile_start),
        static_cast<const float*>(bg), height, width, grid_x,
        static_cast<float*>(image), static_cast<float*>(t_final));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point for ctypes. Returns cudaGetLastError() after the launch (0 = success);
// an unsupported feature count returns cudaErrorInvalidValue without launching.
extern "C" int blend_fwd(const void* means2d, const void* conics, const void* opacities,
                         const void* visible, const void* colors, const void* features,
                         const void* gauss_id, const void* tile_start, const void* bg,
                         int num_feat, int height, int width, int grid_x, int num_tiles,
                         void* image, void* t_final, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLEND_FWD_CASE(F)                                                            \
    case F:                                                                          \
        return launch<F>(means2d, conics, opacities, visible, colors, features,      \
                         gauss_id, tile_start, bg, height, width, grid_x, num_tiles, \
                         image, t_final, s);
    switch (num_feat) {
        BLEND_FWD_CASE(0)
        BLEND_FWD_CASE(1)
        BLEND_FWD_CASE(2)
        BLEND_FWD_CASE(3)
        BLEND_FWD_CASE(4)
        BLEND_FWD_CASE(5)
        BLEND_FWD_CASE(6)
        BLEND_FWD_CASE(7)
        BLEND_FWD_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef BLEND_FWD_CASE
}
