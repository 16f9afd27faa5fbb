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

#pragma once

#include <cuda_runtime.h>

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

}  // namespace blend
