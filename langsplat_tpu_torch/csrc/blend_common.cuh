// Arithmetic shared by the blend forward (blend_fwd.cu) and backward (blend_bwd.cu).
//
// The backward replays the forward front to back and must include exactly the
// (instance, pixel) pairs the forward blended, and must reach the same final
// transmittance bit for bit. So both kernels take the Gaussian falloff, the alpha and
// the transmittance step from these functions. Every product and sum is written with a
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which nvcc never
// contracts into an FMA, so the same inputs give the same bits in both kernels
// whatever code surrounds the call. expf is the accurate libdevice function, not
// __expf; nothing is built with fast-math.
//
// Both kernels also take their cull from here (stage_batch below): each warp of a
// tile's block owns an 8x4 pixel region and evaluates only the instances whose
// alpha >= 1/255 ellipse may reach it.

#pragma once

#include <cuda_runtime.h>

#include <cfloat>

namespace blend {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kTermEps = 1e-4f;

// power = -0.5 (a dx^2 + c dy^2) - b dx dy for the conic (a, b, c)
__device__ __forceinline__ float falloff_power(float dx, float dy, float a, float b,
                                               float c) {
    const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                 __fmul_rn(__fmul_rn(c, dy), dy));
    return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
}

// opacity * exp(power), before the 0.99 clamp; `power` must be <= 0
__device__ __forceinline__ float raw_alpha(float opacity, float gexp) {
    return __fmul_rn(opacity, gexp);
}

// transmittance after blending `alpha` into a pixel whose transmittance is T
__device__ __forceinline__ float next_transmittance(float T, float alpha) {
    return __fmul_rn(T, __fsub_rn(1.0f, alpha));
}

// ---------------------------------------------------------------------------
// The warp-region cull
// ---------------------------------------------------------------------------
//
// Warp w of a tile's 256 threads takes columns (w % 2) * 8 .. + 7 and rows (w / 2) * 4
// .. + 3 of the tile, lane l the pixel (l % 8, l / 8) of that region. An instance is
// tested against the tile and against each region: the minimum over the region's pixel
// box of the conic quadratic Q = -power, against lambda = ln(opacity / (1/255)), as
// binning's exact tile cull does (langsplat_tpu/ops/tiles.py:137-182). A warp skips an
// instance whose minimum exceeds lambda by a margin that covers every rounding of the
// per-pixel test, so every pair the cull skips has alpha < 1/255 (the per-pixel test
// would skip it too), and the per-pixel test still decides every pair that is kept.

constexpr int kWarps = kBlock / 32;
constexpr int kRegionW = 8;   // a warp's pixels: 8 columns x 4 rows of its tile
constexpr int kRegionH = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kAllRegions = (1u << kWarps) - 1u;

// The cull's constants; ops/rasterize_cuda.py (warp_region_keep) mirrors them and the
// arithmetic below, operation for operation.
constexpr float kLnInvAlphaEps = 5.5412636f;   // -ln(1/255)
constexpr float kCullAbs = 1e-4f;      // lambda's margin: expf, the product, logf
constexpr float kCullLamRel = 1e-5f;
constexpr float kCullRel = 8e-5f;      // 2 kappa * 4, kappa = 1e-5 >> the ~5e-7 relative
                                       // rounding of Q against its terms' magnitude
constexpr float kCullMag = 1e30f;      // beyond this the terms could overflow

__device__ __forceinline__ float fmul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ float fadd(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ float fsub(float x, float y) { return __fsub_rn(x, y); }

// Q = 0.5 (a dx^2 + c dy^2) + b dx dy
__device__ __forceinline__ float quad(float dx, float dy, float a, float b, float c) {
    return fadd(fmul(0.5f, fadd(fmul(fmul(a, dx), dx), fmul(fmul(c, dy), dy))),
                fmul(fmul(b, dx), dy));
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return fminf(fmaxf(x, lo), hi);
}

// The minimum of Q over the box [x0, x1] x [y0, y1] (offsets from the mean): 0 if the
// mean lies inside, else the least of the four edges' 1D minima. Needs a, c > 0.
__device__ __forceinline__ float box_qmin(float x0, float x1, float y0, float y1, float a,
                                          float b, float c) {
    if (x0 <= 0.0f && 0.0f <= x1 && y0 <= 0.0f && 0.0f <= y1) return 0.0f;
    const float e0 = quad(x0, clampf(__fdiv_rn(fmul(-b, x0), c), y0, y1), a, b, c);
    const float e1 = quad(x1, clampf(__fdiv_rn(fmul(-b, x1), c), y0, y1), a, b, c);
    const float e2 = quad(clampf(__fdiv_rn(fmul(-b, y0), a), x0, x1), y0, a, b, c);
    const float e3 = quad(clampf(__fdiv_rn(fmul(-b, y1), a), x0, x1), y1, a, b, c);
    return fminf(fminf(e0, e1), fminf(e2, e3));
}

// May the pixels px0..px1 x py0..py1 receive alpha >= 1/255 from the Gaussian? False
// only when the box's minimum of Q, shrunk by the factor f, exceeds lambda plus its
// margin lam_m, and every term of Q stays far from overflow (NaN fails every test).
// Why that is exact: the per-pixel power is -Q + e with |e| <= ~5e-7 S, S = 0.5 (a dx^2
// + c dy^2) + |b dx dy| <= K Q and K = (1 + rho) / (1 - rho) <= 4ac / det (rho =
// |b| / sqrt(ac)), and the box's Q is computed with the same relative error; f = 1 -
// 8e-5 ac / det covers both with a 20-fold reserve.
__device__ __forceinline__ bool box_keep(int px0, int px1, int py0, int py1, float mx,
                                         float my, float a, float b, float c, float f,
                                         float lam_m) {
    const float x0 = fsub(static_cast<float>(px0), mx);
    const float x1 = fsub(static_cast<float>(px1), mx);
    const float y0 = fsub(static_cast<float>(py0), my);
    const float y1 = fsub(static_cast<float>(py1), my);
    const float s2 = fadd(fadd(fmul(x0, x0), fmul(x1, x1)), fadd(fmul(y0, y0), fmul(y1, y1)));
    const float mag = fmul(fadd(fadd(a, fabsf(b)), c), s2);
    if (!(mag < kCullMag)) return true;
    return !(fmul(box_qmin(x0, x1, y0, y1, a, b, c), f) > lam_m);
}

// The instance's factor f and lambda plus its margin, lam_m; false where the test
// cannot be trusted (opacity <= 0 or not finite, a conic that is not positive definite
// or nearly degenerate, NaN anywhere), and then every region is kept.
__device__ __forceinline__ bool cull_terms(float a, float b, float c, float opa, float& f,
                                           float& lam_m) {
    if (!(opa > 0.0f && opa <= FLT_MAX && a > 0.0f && c > 0.0f)) return false;
    const float det = fsub(fmul(a, c), fmul(b, b));
    if (!(det > 0.0f)) return false;
    f = fsub(1.0f, fmul(kCullRel, __fdiv_rn(fmul(a, c), det)));
    if (!(f > 0.5f)) return false;
    const float lam = fadd(logf(opa), kLnInvAlphaEps);
    lam_m = fadd(lam, fadd(kCullAbs, fmul(kCullLamRel, fabsf(lam))));
    return true;
}

// box_keep over the tile whose top-left pixel is (tx0, ty0)
__device__ __forceinline__ bool tile_keep(int tx0, int ty0, float mx, float my, float a,
                                          float b, float c, float f, float lam_m) {
    return box_keep(tx0, tx0 + kTile - 1, ty0, ty0 + kTile - 1, mx, my, a, b, c, f, lam_m);
}

// box_keep over warp w's region of that tile
__device__ __forceinline__ bool region_keep(int w, int tx0, int ty0, float mx, float my,
                                            float a, float b, float c, float f,
                                            float lam_m) {
    const int rx0 = tx0 + (w % 2) * kRegionW;
    const int ry0 = ty0 + (w / 2) * kRegionH;
    return box_keep(rx0, rx0 + kRegionW - 1, ry0, ry0 + kRegionH - 1, mx, my, a, b, c, f,
                    lam_m);
}

// Shared memory of stage_batch, besides the batch's means, conics and masks
struct MaskScratch {
    float2 terms[kBlock];         // f, lam_m of the instances whose tile test passed
    unsigned char pass[kBlock];   // those instances' batch positions, compacted
    int npass[kWarps];
};

// Stages the batch of instances base .. base + kBlock - 1 (those below end) of the tile
// whose top-left pixel is (tx0, ty0) and computes their masks, with the whole block:
// every thread calls it. Thread t takes instance i = base + t, of Gaussian g =
// gauss_id[i]: it gathers g's mean into s_mean[t] and its conic and opacity (0 where g
// is not visible) into s_conic_opa[t], tests them against the tile, and calls
// gather(g, i) for the kernel's own attributes where the instance may get a bit. Bit w
// of s_mask[t]: warp w's region may receive alpha >= 1/255 from instance t. Every bit
// is set where the test cannot be trusted; none where the tile test fails. The
// instances whose tile test passes are compacted, and their eight region tests are
// spread over the block, one a thread (lanes 8q .. 8q + 7 test one instance, and the
// ballot's byte q is its mask), so that no warp runs the region tests of all its 32
// instances because one of them passed. Ends with a barrier, after which the batch is
// staged.
template <class Gather>
__device__ __forceinline__ void stage_batch(int base, int end, int tx0, int ty0,
                                            const int* __restrict__ gauss_id,
                                            const float* __restrict__ means2d,
                                            const float* __restrict__ conics,
                                            const float* __restrict__ opacities,
                                            const bool* __restrict__ visible,
                                            float2* s_mean, float4* s_conic_opa,
                                            unsigned char* s_mask, MaskScratch& s,
                                            Gather&& gather) {
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int i = base + threadIdx.x;
    unsigned mask = 0u;
    bool pass = false;
    if (i < end) {
        const int g = gauss_id[i];
        const float2 m = make_float2(means2d[2 * g], means2d[2 * g + 1]);
        const float4 co = make_float4(conics[3 * g], conics[3 * g + 1], conics[3 * g + 2],
                                      visible[g] ? opacities[g] : 0.0f);
        s_mean[threadIdx.x] = m;
        s_conic_opa[threadIdx.x] = co;
        float f, lam_m;
        if (!cull_terms(co.x, co.y, co.z, co.w, f, lam_m)) {
            mask = kAllRegions;
        } else if (tile_keep(tx0, ty0, m.x, m.y, co.x, co.y, co.z, f, lam_m)) {
            pass = true;
            s.terms[threadIdx.x] = make_float2(f, lam_m);
        }
        if (mask != 0u || pass) gather(g, i);
    }
    s_mask[threadIdx.x] = static_cast<unsigned char>(mask);
    // the instances whose tile test passed, compacted in batch order
    const unsigned passed = __ballot_sync(kFull, pass);
    if (lane == 0) s.npass[warp] = __popc(passed);
    __syncthreads();
    int offset = 0;
    int npass = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const int n = s.npass[w];
        offset += w < warp ? n : 0;
        npass += n;
    }
    if (pass)
        s.pass[offset + __popc(passed & ((1u << lane) - 1u))] =
            static_cast<unsigned char>(threadIdx.x);
    __syncthreads();
    // their region tests, one a thread
    for (int j0 = 0; j0 < npass * kWarps; j0 += kBlock) {
        const int j = j0 + threadIdx.x;
        bool keep = false;
        int k = 0;
        if (j < npass * kWarps) {
            k = s.pass[j / kWarps];
            const float2 mk = s_mean[k];
            const float4 ck = s_conic_opa[k];
            const float2 tk = s.terms[k];
            keep = region_keep(j % kWarps, tx0, ty0, mk.x, mk.y, ck.x, ck.y, ck.z, tk.x,
                               tk.y);
        }
        const unsigned bits = __ballot_sync(kFull, keep);
        if (j < npass * kWarps && lane % kWarps == 0)
            s_mask[k] = static_cast<unsigned char>(bits >> lane);
    }
    __syncthreads();
}

}  // namespace blend
