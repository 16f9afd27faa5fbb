// Projection and SH, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this layer
// (langsplat_tpu/ops/projection.py preprocess, SH in core/sh.py) to XLA's fusion. The
// port ran the same arithmetic as ~500 elementwise PyTorch launches forward and ~960 in
// autograd's backward (zero-filled select gradients included). Here one thread takes one
// Gaussian, with every intermediate in registers: one launch forward, one backward.
//
// Contract (ops/projection.py preprocess_plain, core/transforms.py, core/sh.py):
//   forward:  means3d, scales (activated), quats (raw, normalised here) or cov3d_precomp,
//             SH [n, K, 3] of active degree D (or no SH: the caller's colours pass
//             through), the row-vector view / clip matrices, the camera centre ->
//             means2d, depth, conic, radius, colour max(SH + 0.5, 0), tile rect, visible;
//   backward: dL/dmeans2d, dL/ddepth, dL/dconic, dL/dcolour (each may be absent, read
//             through its strides) -> dL/dmeans3d, dL/dscales, dL/dquats or
//             dL/dcov3d_precomp, dL/dSH (all K coefficients, zero past the active ones).
//
// Numbers. The source is built with --fmad=false (ops/_build.py), so every + and *
// rounds alone, in the plain version's expression order, as the card's PyTorch runs it
// one elementwise kernel at a time. Where the card's ATen differs from the written
// expression, this follows ATen: torch.linalg.vector_norm over 4 values sums
// (a0^2 + a2^2) + (a1^2 + a3^2), over 3 values (a0^2 + a2^2) + a1^2; a division by a
// Python scalar is a product with its float reciprocal, floor_divide is ATen's
// div_floor with that reciprocal; clamp, clamp_min and maximum keep NaN; a float->int32
// cast of _trunc_clip's clamped value truncates. So radii, tile rects and `visible` are
// bit-equal to the plain version on the card, and the float outputs equal it too.
// The backward is autograd's chain rule written out, with autograd's choices at the
// edges: clamp and clamp_min pass the gradient at equality, det == 0 gives zero, a
// zero norm passes none through its normalisation.
//
// What bounds it: device-memory bytes. At SH degree 3 the forward reads 232 B a Gaussian
// (xyz, scales, quats, 48 SH floats) and writes 57; the backward reads ~260 and writes
// 232; either does a few hundred FP32 operations, far under the card's 67 TFLOP/s.
// Design against it: the SH rows, two thirds of the bytes, go through shared memory. A
// block's 128 Gaussians' active coefficients are copied in with coalesced loads of their
// contiguous span (only the active degree's prefix of each row), and the backward writes
// its dL/dSH rows back the same way, zeros for the inactive coefficients included, so no
// gradient is zero-filled apart. Everything else is one thread's own few words, which a
// warp reads as a few contiguous segments.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

// A Python float scalar reaches a float32 kernel rounded from double: so do these.
#define F32(x) static_cast<float>(x)
#define C0 F32(0.28209479177387814)
#define C1 F32(0.4886025119029199)
#define C2_0 F32(1.0925484305920792)
#define C2_1 F32(-1.0925484305920792)
#define C2_2 F32(0.31539156525252005)
#define C2_3 F32(-1.0925484305920792)
#define C2_4 F32(0.5462742152960396)
#define C3_0 F32(-0.5900435899266435)
#define C3_1 F32(2.890611442640554)
#define C3_2 F32(-0.4570457994644658)
#define C3_3 F32(0.3731763325901154)
#define C3_4 F32(-0.4570457994644658)
#define C3_5 F32(1.445305721320277)
#define C3_6 F32(-0.5900435899266435)
#define C4_0 F32(2.5033429417967046)
#define C4_1 F32(-1.7701307697799304)
#define C4_2 F32(0.9461746957575601)
#define C4_3 F32(-0.6690465435572892)
#define C4_4 F32(0.10578554691520431)
#define C4_5 F32(-0.6690465435572892)
#define C4_6 F32(0.47308734787878004)
#define C4_7 F32(-1.7701307697799304)
#define C4_8 F32(0.6258357354491761)

struct Params {
    int n, num_coeffs, width, height, tile, grid_x, grid_y;
    float focal_x, focal_y, lim_x, lim_y, scale_mod;
    int view_s0, view_s1, proj_s0, proj_s1, campos_s0;   // the camera's strides
};

__device__ __forceinline__ float clamp_keep_nan(float v, float lo, float hi) {   // torch.clamp
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float max_keep_nan(float a, float b) {   // torch.maximum
    if (isnan(a)) return a;
    if (isnan(b)) return b;
    return fmaxf(a, b);
}

// ops/projection.py _trunc_clip: NaN -> 0, clamp to [-1, hi + 1], truncate, clamp to [0, hi]
__device__ __forceinline__ int trunc_clip(float x, int hi) {
    x = isnan(x) ? 0.0f : x;
    x = fminf(fmaxf(x, -1.0f), F32(static_cast<double>(hi) + 1.0));
    return min(max(static_cast<int>(x), 0), hi);
}

// torch.floor_divide(a, b) for a Python scalar b, as the card's ATen computes it
__device__ __forceinline__ float floor_div(float a, float b, float inv_b) {
    const float mod = fmodf(a, b);
    float div = (a - mod) * inv_b;
    if ((mod != 0.0f) && ((b < 0.0f) != (mod < 0.0f))) div -= 1.0f;
    if (div == 0.0f) return copysignf(0.0f, a * inv_b);
    float floordiv = floorf(div);
    if (div - floordiv > 0.5f) floordiv += 1.0f;
    return floordiv;
}

// Everything the forward computes from one Gaussian's geometry, kept for the backward.
struct Geometry {
    float t[3];                 // view-space position
    float h[4], hw;             // clip-space position, w + 1e-7
    float w, x, y, z, qnorm, qd;   // normalised quaternion, |q|, |q| + 1e-12
    float R[3][3], s[3], L[3][3];
    float cov[3][3];            // 3D covariance
    float r0, r1;               // t.x / t.z, t.y / t.z before their clamps
    float txtz, tytz, tx, ty, inv_z, inv_z2;
    float J00, J02, J11, J12;
    float T[2][3], TS[2][3];
    float a, b, c, det, inv_det;  // 2D covariance (xx, xy, yy), its determinant
    bool det_ok;
};

// core/transforms.py build_covariance_3d (quaternion normalised inside)
__device__ __forceinline__ void covariance(const float* scale, const float* quat, float smod,
                                           Geometry& g) {
    const float qw = quat[0], qx = quat[1], qy = quat[2], qz = quat[3];
    g.qnorm = sqrtf((qw * qw + qy * qy) + (qx * qx + qz * qz));
    g.qd = g.qnorm + F32(1e-12);
    const float w = qw / g.qd, x = qx / g.qd, y = qy / g.qd, z = qz / g.qd;
    g.w = w; g.x = x; g.y = y; g.z = z;
    g.R[0][0] = 1.0f - 2.0f * (y * y + z * z);
    g.R[0][1] = 2.0f * (x * y - w * z);
    g.R[0][2] = 2.0f * (x * z + w * y);
    g.R[1][0] = 2.0f * (x * y + w * z);
    g.R[1][1] = 1.0f - 2.0f * (x * x + z * z);
    g.R[1][2] = 2.0f * (y * z - w * x);
    g.R[2][0] = 2.0f * (x * z - w * y);
    g.R[2][1] = 2.0f * (y * z + w * x);
    g.R[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
    for (int k = 0; k < 3; ++k) g.s[k] = scale[k] * smod;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k) g.L[i][k] = g.R[i][k] * g.s[k];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            g.cov[i][j] = ((0.0f + g.L[i][0] * g.L[j][0]) + g.L[i][1] * g.L[j][1])
                          + g.L[i][2] * g.L[j][2];
}

// ops/projection.py project_points and compute_cov2d; V, P row-vector 4x4 (row-major)
__device__ __forceinline__ void project(const float m[3], const float* V, const float* P,
                                        const Params& p, Geometry& g) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
        g.t[k] = ((m[0] * V[k] + m[1] * V[4 + k]) + m[2] * V[8 + k]) + V[12 + k];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        g.h[k] = ((m[0] * P[k] + m[1] * P[4 + k]) + m[2] * P[8 + k]) + P[12 + k];
    g.hw = g.h[3] + F32(1e-7);

    const float tz = g.t[2];
    g.r0 = g.t[0] / tz;
    g.r1 = g.t[1] / tz;
    g.txtz = clamp_keep_nan(g.r0, -p.lim_x, p.lim_x);
    g.tytz = clamp_keep_nan(g.r1, -p.lim_y, p.lim_y);
    g.tx = g.txtz * tz;
    g.ty = g.tytz * tz;
    g.inv_z = 1.0f / tz;
    g.inv_z2 = g.inv_z * g.inv_z;
    g.J00 = g.inv_z * p.focal_x;
    g.J02 = (g.tx * -p.focal_x) * g.inv_z2;
    g.J11 = g.inv_z * p.focal_y;
    g.J12 = (g.ty * -p.focal_y) * g.inv_z2;
    // T = J W with W[j][k] = V[k][j]; J's zeros enter as the plain version's zeros tensor
    const float J[2][3] = {{g.J00, 0.0f, g.J02}, {0.0f, g.J11, g.J12}};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            g.T[i][k] = ((0.0f + J[i][0] * V[4 * k]) + J[i][1] * V[4 * k + 1])
                        + J[i][2] * V[4 * k + 2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
            g.TS[i][k] = ((0.0f + g.T[i][0] * g.cov[0][k]) + g.T[i][1] * g.cov[1][k])
                         + g.T[i][2] * g.cov[2][k];
    g.a = (((0.0f + g.TS[0][0] * g.T[0][0]) + g.TS[0][1] * g.T[0][1]) + g.TS[0][2] * g.T[0][2])
          + F32(0.3);
    g.b = ((0.0f + g.TS[0][0] * g.T[1][0]) + g.TS[0][1] * g.T[1][1]) + g.TS[0][2] * g.T[1][2];
    g.c = (((0.0f + g.TS[1][0] * g.T[1][0]) + g.TS[1][1] * g.T[1][1]) + g.TS[1][2] * g.T[1][2])
          + F32(0.3);
    g.det = g.a * g.c - g.b * g.b;
    g.det_ok = g.det != 0.0f;
    g.inv_det = g.det_ok ? 1.0f / g.det : 0.0f;
}

__device__ __forceinline__ void geometry(const float m[3], const float* scale, const float* quat,
                                         const float* cov6, const float* V, const float* P,
                                         const Params& p, Geometry& g) {
    if (cov6 != nullptr) {
        const float c6[6] = {cov6[0], cov6[1], cov6[2], cov6[3], cov6[4], cov6[5]};
        const int idx[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) g.cov[i][j] = c6[idx[i][j]];
    } else {
        covariance(scale, quat, p.scale_mod, g);
    }
    project(m, V, P, p, g);
}

// core/sh.py eval_sh's factors: term i is basis[i] * sh_i, subtracted for i = 1 and 3
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* b) {
    b[0] = C0;
    if (D > 0) {
        b[1] = C1 * y;
        b[2] = C1 * z;
        b[3] = C1 * x;
    }
    if (D > 1) {
        const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
        b[4] = C2_0 * xy;
        b[5] = C2_1 * yz;
        b[6] = C2_2 * ((2.0f * zz - xx) - yy);
        b[7] = C2_3 * xz;
        b[8] = C2_4 * (xx - yy);
        if (D > 2) {
            b[9] = (C3_0 * y) * (3.0f * xx - yy);
            b[10] = (C3_1 * xy) * z;
            b[11] = (C3_2 * y) * ((4.0f * zz - xx) - yy);
            b[12] = (C3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
            b[13] = (C3_4 * x) * ((4.0f * zz - xx) - yy);
            b[14] = (C3_5 * z) * (xx - yy);
            b[15] = (C3_6 * x) * (xx - 3.0f * yy);
        }
        if (D > 3) {
            b[16] = (C4_0 * xy) * (xx - yy);
            b[17] = (C4_1 * yz) * (3.0f * xx - yy);
            b[18] = (C4_2 * xy) * (7.0f * zz - 1.0f);
            b[19] = (C4_3 * yz) * (7.0f * zz - 3.0f);
            b[20] = C4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
            b[21] = (C4_5 * xz) * (7.0f * zz - 3.0f);
            b[22] = (C4_6 * (xx - yy)) * (7.0f * zz - 1.0f);
            b[23] = (C4_7 * xz) * (xx - 3.0f * yy);
            b[24] = C4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
        }
    }
}

// core/sh.py eval_sh for one channel, summed in its order; sh[i * 3] is coefficient i
template <int D>
__device__ __forceinline__ float eval_sh(const float* b, const float* sh) {
    float result = sh[0] * b[0];
    if (D > 0) result = ((result - b[1] * sh[3]) + b[2] * sh[6]) - b[3] * sh[9];
#pragma unroll
    for (int i = 4; i < (D + 1) * (D + 1); ++i) result = result + b[i] * sh[3 * i];
    return result;
}

// The gradient of basis term i (its sign included) at (x, y, z), added times `w`.
template <int D>
__device__ __forceinline__ void sh_basis_grad(float x, float y, float z, const float* w,
                                              float* gd) {
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
    if (D > 0) {
        gy -= C1 * w[1];
        gz += C1 * w[2];
        gx -= C1 * w[3];
    }
    if (D > 1) {
        const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
        gx += C2_0 * y * w[4];
        gy += C2_0 * x * w[4];
        gy += C2_1 * z * w[5];
        gz += C2_1 * y * w[5];
        gx += -2.0f * C2_2 * x * w[6];
        gy += -2.0f * C2_2 * y * w[6];
        gz += 4.0f * C2_2 * z * w[6];
        gx += C2_3 * z * w[7];
        gz += C2_3 * x * w[7];
        gx += 2.0f * C2_4 * x * w[8];
        gy += -2.0f * C2_4 * y * w[8];
        if (D > 2) {
            gx += C3_0 * 6.0f * xy * w[9];
            gy += C3_0 * (3.0f * xx - 3.0f * yy) * w[9];
            gx += C3_1 * yz * w[10];
            gy += C3_1 * xz * w[10];
            gz += C3_1 * xy * w[10];
            gx += C3_2 * -2.0f * xy * w[11];
            gy += C3_2 * (4.0f * zz - xx - 3.0f * yy) * w[11];
            gz += C3_2 * 8.0f * yz * w[11];
            gx += C3_3 * -6.0f * xz * w[12];
            gy += C3_3 * -6.0f * yz * w[12];
            gz += C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * w[12];
            gx += C3_4 * (4.0f * zz - 3.0f * xx - yy) * w[13];
            gy += C3_4 * -2.0f * xy * w[13];
            gz += C3_4 * 8.0f * xz * w[13];
            gx += C3_5 * 2.0f * xz * w[14];
            gy += C3_5 * -2.0f * yz * w[14];
            gz += C3_5 * (xx - yy) * w[14];
            gx += C3_6 * (3.0f * xx - 3.0f * yy) * w[15];
            gy += C3_6 * -6.0f * xy * w[15];
        }
        if (D > 3) {
            gx += C4_0 * y * (3.0f * xx - yy) * w[16];
            gy += C4_0 * x * (xx - 3.0f * yy) * w[16];
            gx += C4_1 * 6.0f * xy * z * w[17];
            gy += C4_1 * 3.0f * z * (xx - yy) * w[17];
            gz += C4_1 * y * (3.0f * xx - yy) * w[17];
            gx += C4_2 * y * (7.0f * zz - 1.0f) * w[18];
            gy += C4_2 * x * (7.0f * zz - 1.0f) * w[18];
            gz += C4_2 * 14.0f * xy * z * w[18];
            gy += C4_3 * z * (7.0f * zz - 3.0f) * w[19];
            gz += C4_3 * y * (21.0f * zz - 3.0f) * w[19];
            gz += C4_4 * z * (140.0f * zz - 60.0f) * w[20];
            gx += C4_5 * z * (7.0f * zz - 3.0f) * w[21];
            gz += C4_5 * x * (21.0f * zz - 3.0f) * w[21];
            gx += C4_6 * 2.0f * x * (7.0f * zz - 1.0f) * w[22];
            gy += C4_6 * -2.0f * y * (7.0f * zz - 1.0f) * w[22];
            gz += C4_6 * 14.0f * z * (xx - yy) * w[22];
            gx += C4_7 * z * (3.0f * xx - 3.0f * yy) * w[23];
            gy += C4_7 * -6.0f * xy * z * w[23];
            gz += C4_7 * x * (xx - 3.0f * yy) * w[23];
            gx += C4_8 * 4.0f * x * (xx - 3.0f * yy) * w[24];
            gy += C4_8 * 4.0f * y * (yy - 3.0f * xx) * w[24];
        }
    }
    gd[0] = gx;
    gd[1] = gy;
    gd[2] = gz;
}

// The unit direction from the camera centre, as preprocess_plain normalises it
__device__ __forceinline__ void view_dir(const float m[3], const float* campos, float v[3],
                                         float& norm, float& d, float dir[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = m[k] - campos[k];
    norm = sqrtf((v[0] * v[0] + v[2] * v[2]) + v[1] * v[1]);
    d = norm + F32(1e-12);
#pragma unroll
    for (int k = 0; k < 3; ++k) dir[k] = v[k] / d;
}

// The gradient of u / (|u| + 1e-12) at u (norm = |u|, d = |u| + 1e-12), as autograd's
// division and vector_norm backward give it, added to g_u.
template <int K>
__device__ __forceinline__ void normalize_backward(const float* u, float norm, float d,
                                                   const float* g_out, float* g_u) {
    float dot = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) dot += g_out[k] * u[k];
    const float g_norm = -dot / (d * d);
    const float scale = norm == 0.0f ? 0.0f : g_norm / norm;
#pragma unroll
    for (int k = 0; k < K; ++k) g_u[k] += g_out[k] / d + u[k] * scale;
}

// Copy the first `cols` floats of rows g0 .. g0 + count - 1 of a [n, row] array into
// s[r * stride + c], coalesced over the block.
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int row, int cols,
                                           int g0, int count, float* s, int stride) {
    for (int e = threadIdx.x; e < count * cols; e += kThreads) {
        const int r = e / cols, c = e - r * cols;
        s[r * stride + c] = src[static_cast<size_t>(g0 + r) * row + c];
    }
}

// The camera's 16 + 16 + 3 floats, read through their strides, into shared memory for
// the block (row-major matrices there)
__device__ __forceinline__ void stage_camera(const float* view, const float* proj,
                                             const float* campos, const Params& p,
                                             float* s_cam) {
    const int i = threadIdx.x;
    if (i < 16) s_cam[i] = view[(i / 4) * p.view_s0 + (i % 4) * p.view_s1];
    else if (i < 32) s_cam[i] = proj[((i - 16) / 4) * p.proj_s0 + (i % 4) * p.proj_s1];
    else if (i < 35) s_cam[i] = campos[(i - 32) * p.campos_s0];
}

__host__ __device__ constexpr int odd_stride(int cols) { return cols | 1; }

template <int D>
__global__ void __launch_bounds__(kThreads)
preprocess_fwd_kernel(const float* __restrict__ means3d, const float* __restrict__ scales,
                      const float* __restrict__ quats, const float* __restrict__ shs,
                      const float* __restrict__ cov3d_precomp,
                      const unsigned char* __restrict__ alive, const float* __restrict__ view,
                      const float* __restrict__ proj, const float* __restrict__ campos,
                      Params p, float* __restrict__ means2d, float* __restrict__ depths,
                      float* __restrict__ conics, int* __restrict__ radii,
                      float* __restrict__ colors, int* __restrict__ tiles_min,
                      int* __restrict__ tiles_max, unsigned char* __restrict__ visible) {
    constexpr int kCols = 3 * (D + 1) * (D + 1);
    constexpr int kStride = odd_stride(kCols);
    __shared__ float s_cam[35];
    extern __shared__ float s_sh[];   // [kThreads][kStride]: the block's active SH
    const int g0 = blockIdx.x * kThreads;
    const int g = g0 + threadIdx.x;
    stage_camera(view, proj, campos, p, s_cam);
    if (shs != nullptr)
        stage_rows(shs, 3 * p.num_coeffs, kCols, g0, min(kThreads, p.n - g0), s_sh, kStride);
    __syncthreads();
    if (g >= p.n) return;
    const float* V = s_cam;
    const float* P = s_cam + 16;

    const float m[3] = {means3d[3 * g], means3d[3 * g + 1], means3d[3 * g + 2]};
    Geometry geo;
    geometry(m, scales + 3 * g, quats + 4 * g,
             cov3d_precomp == nullptr ? nullptr : cov3d_precomp + 6 * static_cast<size_t>(g),
             V, P, p, geo);

    const float mid = 0.5f * (geo.a + geo.c);
    const float disc = sqrtf(clamp_keep_nan(mid * mid - geo.det, F32(0.1), INFINITY));
    const float radius_f = ceilf(3.0f * sqrtf(max_keep_nan(mid + disc, mid - disc)));

    const float ndc_x = geo.h[0] / geo.hw, ndc_y = geo.h[1] / geo.hw;
    const float mx = ((ndc_x + 1.0f) * F32(p.width) - 1.0f) * 0.5f;
    const float my = ((ndc_y + 1.0f) * F32(p.height) - 1.0f) * 0.5f;

    const float tile = F32(p.tile), inv_tile = 1.0f / tile;
    const int tmin_x = trunc_clip((mx - radius_f) * inv_tile, p.grid_x);
    const int tmin_y = trunc_clip((my - radius_f) * inv_tile, p.grid_y);
    const int tmax_x = trunc_clip(floor_div(((mx + radius_f) + tile) - 1.0f, tile, inv_tile),
                                  p.grid_x);
    const int tmax_y = trunc_clip(floor_div(((my + radius_f) + tile) - 1.0f, tile, inv_tile),
                                  p.grid_y);
    const bool touches = (tmax_x - tmin_x) * (tmax_y - tmin_y) > 0;
    const bool vis = (geo.t[2] > F32(0.2)) && geo.det_ok && touches
                     && (alive == nullptr || alive[g] != 0);

    means2d[2 * g] = mx;
    means2d[2 * g + 1] = my;
    depths[g] = geo.t[2];
    conics[3 * g] = geo.c * geo.inv_det;
    conics[3 * g + 1] = -geo.b * geo.inv_det;
    conics[3 * g + 2] = geo.a * geo.inv_det;
    radii[g] = trunc_clip(vis ? radius_f : 0.0f, 1 << 30);
    tiles_min[2 * g] = tmin_x;
    tiles_min[2 * g + 1] = tmin_y;
    tiles_max[2 * g] = tmax_x;
    tiles_max[2 * g + 1] = tmax_y;
    visible[g] = vis ? 1 : 0;

    if (shs != nullptr) {
        float v[3], norm, d, dir[3];
        view_dir(m, s_cam + 32, v, norm, d, dir);
        float b[25];
        sh_basis<D>(dir[0], dir[1], dir[2], b);
        const float* sh = s_sh + threadIdx.x * kStride;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
            colors[3 * g + ch] = clamp_keep_nan(eval_sh<D>(b, sh + ch) + 0.5f, 0.0f, INFINITY);
    }
}

// A gradient input read through its strides (in elements), zero when absent
struct GradIn {
    const float* ptr;
    long long s0, s1;
    __device__ __forceinline__ float at(int g, int k) const {
        return ptr == nullptr ? 0.0f : ptr[g * s0 + k * s1];
    }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
preprocess_bwd_kernel(const float* __restrict__ means3d, const float* __restrict__ scales,
                      const float* __restrict__ quats, const float* __restrict__ shs,
                      const float* __restrict__ cov3d_precomp, const float* __restrict__ view,
                      const float* __restrict__ proj, const float* __restrict__ campos,
                      Params p, GradIn g_means2d, GradIn g_depths, GradIn g_conics,
                      GradIn g_colors, float* __restrict__ d_means3d,
                      float* __restrict__ d_scales, float* __restrict__ d_quats,
                      float* __restrict__ d_shs, float* __restrict__ d_cov3d) {
    constexpr int kCols = 3 * (D + 1) * (D + 1);
    const int row = 3 * p.num_coeffs;
    const int stride = odd_stride(row);
    __shared__ float s_cam[35];
    extern __shared__ float s_sh[];   // [kThreads][stride]: SH in, then dL/dSH out
    const int g0 = blockIdx.x * kThreads;
    const int g = g0 + threadIdx.x;
    const int count = min(kThreads, p.n - g0);
    stage_camera(view, proj, campos, p, s_cam);
    if (shs != nullptr) stage_rows(shs, row, kCols, g0, count, s_sh, stride);
    __syncthreads();
    const float* V = s_cam;
    const float* P = s_cam + 16;

    if (g < p.n) {
        const float m[3] = {means3d[3 * g], means3d[3 * g + 1], means3d[3 * g + 2]};
        const float* cov6 =
            cov3d_precomp == nullptr ? nullptr : cov3d_precomp + 6 * static_cast<size_t>(g);
        Geometry geo;
        geometry(m, scales + 3 * g, quats + 4 * g, cov6, V, P, p, geo);
        float gm[3] = {0.0f, 0.0f, 0.0f};

        // means2d = ((h / hw + 1) * size - 1) * 0.5
        const float g_ndc_x = (g_means2d.at(g, 0) * 0.5f) * F32(p.width);
        const float g_ndc_y = (g_means2d.at(g, 1) * 0.5f) * F32(p.height);
        const float g_h0 = g_ndc_x / geo.hw, g_h1 = g_ndc_y / geo.hw;
        const float g_hw = -(g_ndc_x * (geo.h[0] / geo.hw) + g_ndc_y * (geo.h[1] / geo.hw))
                           / geo.hw;
        // depth = t.z
        const float g_depth = g_depths.at(g, 0);
#pragma unroll
        for (int j = 0; j < 3; ++j)
            gm[j] += (g_h0 * P[4 * j] + g_h1 * P[4 * j + 1]) + g_hw * P[4 * j + 3]
                     + g_depth * V[4 * j + 2];

        // conic = (c, -b, a) / det
        float g_a = 0.0f, g_b = 0.0f, g_c = 0.0f;
        if (geo.det_ok) {
            const float ga = g_conics.at(g, 0), gb = g_conics.at(g, 1), gc = g_conics.at(g, 2);
            const float g_inv = (ga * geo.c - gb * geo.b) + gc * geo.a;
            const float g_det = -g_inv * (geo.inv_det * geo.inv_det);
            g_a = gc * geo.inv_det + g_det * geo.c;
            g_c = ga * geo.inv_det + g_det * geo.a;
            g_b = -gb * geo.inv_det - 2.0f * g_det * geo.b;
        }
        // (a, b, c) = (T0 S T0, T0 S T1, T1 S T1) through TS = T S
        float g_T[2][3], g_S[3][3];
        float g_TS[2][3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            g_TS[0][k] = g_a * geo.T[0][k] + g_b * geo.T[1][k];
            g_TS[1][k] = g_c * geo.T[1][k];
            g_T[0][k] = g_a * geo.TS[0][k];
            g_T[1][k] = g_b * geo.TS[0][k] + g_c * geo.TS[1][k];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j)
                g_T[i][j] += (g_TS[i][0] * geo.cov[j][0] + g_TS[i][1] * geo.cov[j][1])
                             + g_TS[i][2] * geo.cov[j][2];
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
            for (int k = 0; k < 3; ++k)
                g_S[j][k] = geo.T[0][j] * g_TS[0][k] + geo.T[1][j] * g_TS[1][k];

        // T = J W, W[j][k] = V[k][j]: dL/dJ[i][j] = sum_k dL/dT[i][k] V[k][j]
        auto g_J = [&](int i, int j) {
            return (g_T[i][0] * V[j] + g_T[i][1] * V[4 + j]) + g_T[i][2] * V[8 + j];
        };
        const float g_J00 = g_J(0, 0), g_J02 = g_J(0, 2), g_J11 = g_J(1, 1), g_J12 = g_J(1, 2);
        const float tz = geo.t[2];
        const float g_tx = (g_J02 * geo.inv_z2) * -p.focal_x;
        const float g_ty = (g_J12 * geo.inv_z2) * -p.focal_y;
        const float g_inv_z2 = g_J02 * (geo.tx * -p.focal_x) + g_J12 * (geo.ty * -p.focal_y);
        const float g_inv_z = (g_J00 * p.focal_x + g_J11 * p.focal_y)
                              + 2.0f * geo.inv_z * g_inv_z2;
        float g_tz = -g_inv_z * (geo.inv_z * geo.inv_z) + g_tx * geo.txtz + g_ty * geo.tytz;
        const bool pass_x = geo.r0 >= -p.lim_x && geo.r0 <= p.lim_x;
        const bool pass_y = geo.r1 >= -p.lim_y && geo.r1 <= p.lim_y;
        const float g_r0 = pass_x ? g_tx * tz : 0.0f;
        const float g_r1 = pass_y ? g_ty * tz : 0.0f;
        const float g_t0 = g_r0 / tz, g_t1 = g_r1 / tz;
        g_tz -= (g_r0 * geo.r0 + g_r1 * geo.r1) / tz;
#pragma unroll
        for (int j = 0; j < 3; ++j)
            gm[j] += (g_t0 * V[4 * j] + g_t1 * V[4 * j + 1]) + g_tz * V[4 * j + 2];

        if (cov6 != nullptr) {
            if (d_cov3d != nullptr) {
                float* out = d_cov3d + 6 * static_cast<size_t>(g);
                out[0] = g_S[0][0];
                out[1] = g_S[0][1] + g_S[1][0];
                out[2] = g_S[0][2] + g_S[2][0];
                out[3] = g_S[1][1];
                out[4] = g_S[1][2] + g_S[2][1];
                out[5] = g_S[2][2];
            }
        } else if (d_scales != nullptr || d_quats != nullptr) {
            // cov[i][j] = sum_k L[i][k] L[j][k], L = R diag(s)
            float g_R[3][3], g_s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    float g_L = 0.0f;
#pragma unroll
                    for (int j = 0; j < 3; ++j) g_L += (g_S[i][j] + g_S[j][i]) * geo.L[j][k];
                    g_R[i][k] = g_L * geo.s[k];
                    g_s[k] += g_L * geo.R[i][k];
                }
            if (d_scales != nullptr)
#pragma unroll
                for (int k = 0; k < 3; ++k) d_scales[3 * g + k] = g_s[k] * p.scale_mod;
            if (d_quats != nullptr) {
                const float w = geo.w, x = geo.x, y = geo.y, z = geo.z;
                const float g_qn[4] = {
                    2.0f * (((-z * g_R[0][1] + y * g_R[0][2]) + (z * g_R[1][0] - x * g_R[1][2]))
                            + (-y * g_R[2][0] + x * g_R[2][1])),
                    2.0f * (((y * g_R[0][1] + z * g_R[0][2]) + (y * g_R[1][0] - w * g_R[1][2]))
                            + (z * g_R[2][0] + w * g_R[2][1]))
                        - 4.0f * x * (g_R[1][1] + g_R[2][2]),
                    2.0f * (((x * g_R[0][1] + w * g_R[0][2]) + (x * g_R[1][0] + z * g_R[1][2]))
                            + (-w * g_R[2][0] + z * g_R[2][1]))
                        - 4.0f * y * (g_R[0][0] + g_R[2][2]),
                    2.0f * (((-w * g_R[0][1] + x * g_R[0][2]) + (w * g_R[1][0] + y * g_R[1][2]))
                            + (x * g_R[2][0] + y * g_R[2][1]))
                        - 4.0f * z * (g_R[0][0] + g_R[1][1])};
                const float* q = quats + 4 * g;
                const float qraw[4] = {q[0], q[1], q[2], q[3]};
                float g_q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                normalize_backward<4>(qraw, geo.qnorm, geo.qd, g_qn, g_q);
#pragma unroll
                for (int k = 0; k < 4; ++k) d_quats[4 * g + k] = g_q[k];
            }
        }

        if (shs != nullptr) {
            float* sh = s_sh + threadIdx.x * stride;
            float v[3], norm, d, dir[3];
            view_dir(m, s_cam + 32, v, norm, d, dir);
            float b[25];
            sh_basis<D>(dir[0], dir[1], dir[2], b);
            float gcol[3];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
                // clamp_min(x, 0) passes the gradient where x >= 0
                const float val = eval_sh<D>(b, sh + ch) + 0.5f;
                gcol[ch] = val >= 0.0f ? g_colors.at(g, ch) : 0.0f;
            }
            float w[25];
#pragma unroll
            for (int i = 0; i < (D + 1) * (D + 1); ++i)
                w[i] = (gcol[0] * sh[3 * i] + gcol[1] * sh[3 * i + 1]) + gcol[2] * sh[3 * i + 2];
            float g_dir[3];
            sh_basis_grad<D>(dir[0], dir[1], dir[2], w, g_dir);
            normalize_backward<3>(v, norm, d, g_dir, gm);
            // the row now holds dL/dSH: term i's sign is - for i = 1 and 3
#pragma unroll
            for (int i = 0; i < (D + 1) * (D + 1); ++i) {
                const float bi = (i == 1 || i == 3) ? -b[i] : b[i];
#pragma unroll
                for (int ch = 0; ch < 3; ++ch) sh[3 * i + ch] = gcol[ch] * bi;
            }
            for (int e = kCols; e < row; ++e) sh[e] = 0.0f;
        }
        if (d_means3d != nullptr)
#pragma unroll
            for (int k = 0; k < 3; ++k) d_means3d[3 * g + k] = gm[k];
    }

    if (shs != nullptr && d_shs != nullptr) {
        __syncthreads();
        float* dst = d_shs + static_cast<size_t>(g0) * row;
        for (int e = threadIdx.x; e < count * row; e += kThreads) {
            const int r = e / row;
            dst[e] = s_sh[r * stride + (e - r * row)];
        }
    }
}

inline int blocks(int n) { return (n + kThreads - 1) / kThreads; }

template <int D>
int launch_fwd(const float* means3d, const float* scales, const float* quats, const float* shs,
               const float* cov3d, const unsigned char* alive, const float* view,
               const float* proj, const float* campos, const Params& p, float* means2d,
               float* depths, float* conics, int* radii, float* colors, int* tiles_min,
               int* tiles_max, unsigned char* visible, cudaStream_t stream) {
    const size_t smem =
        shs == nullptr ? 0 : sizeof(float) * kThreads * odd_stride(3 * (D + 1) * (D + 1));
    preprocess_fwd_kernel<D><<<blocks(p.n), kThreads, smem, stream>>>(
        means3d, scales, quats, shs, cov3d, alive, view, proj, campos, p, means2d, depths,
        conics, radii, colors, tiles_min, tiles_max, visible);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const float* means3d, const float* scales, const float* quats, const float* shs,
               const float* cov3d, const float* view, const float* proj, const float* campos,
               const Params& p, GradIn gm2, GradIn gd, GradIn gc, GradIn gcol, float* d_means3d,
               float* d_scales, float* d_quats, float* d_shs, float* d_cov3d,
               cudaStream_t stream) {
    const size_t smem =
        shs == nullptr ? 0 : sizeof(float) * kThreads * odd_stride(3 * p.num_coeffs);
    preprocess_bwd_kernel<D><<<blocks(p.n), kThreads, smem, stream>>>(
        means3d, scales, quats, shs, cov3d, view, proj, campos, p, gm2, gd, gc, gcol,
        d_means3d, d_scales, d_quats, d_shs, d_cov3d);
    return static_cast<int>(cudaGetLastError());
}

Params params(int n, int num_coeffs, int width, int height, int tile, int grid_x, int grid_y,
              float focal_x, float focal_y, float lim_x, float lim_y, float scale_mod,
              const int* cam_strides) {
    return Params{n, num_coeffs, width, height, tile, grid_x, grid_y,
                  focal_x, focal_y, lim_x, lim_y, scale_mod, cam_strides[0], cam_strides[1],
                  cam_strides[2], cam_strides[3], cam_strides[4]};
}

}  // namespace

// C entry points for ctypes. Each returns cudaGetLastError() after its launch (0 =
// success); a degree outside 0-4 returns cudaErrorInvalidValue. The wrapper
// (ops/projection.py) checks shapes, types and sizes: at most 25 coefficients a row, so
// the backward's staging stays under 48 KB of shared memory.
extern "C" int preprocess_fwd(const void* means3d, const void* scales, const void* quats,
                              const void* shs, const void* cov3d_precomp, const void* alive,
                              const void* viewmatrix, const void* projmatrix,
                              const void* campos, int n, int num_coeffs, int sh_degree,
                              int width, int height, int tile, int grid_x, int grid_y,
                              float focal_x, float focal_y, float lim_x, float lim_y,
                              float scale_mod, int view_s0, int view_s1, int proj_s0,
                              int proj_s1, int campos_s0, void* means2d, void* depths,
                              void* conics,
                              void* radii, void* colors, void* tiles_min, void* tiles_max,
                              void* visible, void* stream) {
    if (n <= 0) return 0;
    const int cam_strides[5] = {view_s0, view_s1, proj_s0, proj_s1, campos_s0};
    const Params p = params(n, num_coeffs, width, height, tile, grid_x, grid_y, focal_x,
                            focal_y, lim_x, lim_y, scale_mod, cam_strides);
    auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
    const auto* alive_b = static_cast<const unsigned char*>(alive);
    auto s = static_cast<cudaStream_t>(stream);
    auto* o2 = static_cast<float*>(means2d);
    auto* od = static_cast<float*>(depths);
    auto* oc = static_cast<float*>(conics);
    auto* orad = static_cast<int*>(radii);
    auto* ocol = static_cast<float*>(colors);
    auto* omin = static_cast<int*>(tiles_min);
    auto* omax = static_cast<int*>(tiles_max);
    auto* ovis = static_cast<unsigned char*>(visible);
#define FWD(D)                                                                               \
    launch_fwd<D>(f(means3d), f(scales), f(quats), f(shs), f(cov3d_precomp), alive_b,        \
                  f(viewmatrix), f(projmatrix), f(campos), p, o2, od, oc, orad, ocol, omin,  \
                  omax, ovis, s)
    switch (shs == nullptr ? 0 : sh_degree) {
        case 0: return FWD(0);
        case 1: return FWD(1);
        case 2: return FWD(2);
        case 3: return FWD(3);
        case 4: return FWD(4);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef FWD
}

extern "C" int preprocess_bwd(const void* means3d, const void* scales, const void* quats,
                              const void* shs, const void* cov3d_precomp,
                              const void* viewmatrix, const void* projmatrix,
                              const void* campos, int n, int num_coeffs, int sh_degree,
                              int width, int height, int tile, int grid_x, int grid_y,
                              float focal_x, float focal_y, float lim_x, float lim_y,
                              float scale_mod, int view_s0, int view_s1, int proj_s0,
                              int proj_s1, int campos_s0, const void* g_means2d,
                              long long gm_s0,
                              long long gm_s1, const void* g_depths, long long gd_s0,
                              const void* g_conics, long long gc_s0, long long gc_s1,
                              const void* g_colors, long long gcol_s0, long long gcol_s1,
                              void* d_means3d, void* d_scales, void* d_quats, void* d_shs,
                              void* d_cov3d, void* stream) {
    if (n <= 0) return 0;
    const int cam_strides[5] = {view_s0, view_s1, proj_s0, proj_s1, campos_s0};
    const Params p = params(n, num_coeffs, width, height, tile, grid_x, grid_y, focal_x,
                            focal_y, lim_x, lim_y, scale_mod, cam_strides);
    auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
    const GradIn gm2{f(g_means2d), gm_s0, gm_s1}, gd{f(g_depths), gd_s0, 0},
        gc{f(g_conics), gc_s0, gc_s1}, gcol{f(g_colors), gcol_s0, gcol_s1};
    auto s = static_cast<cudaStream_t>(stream);
    auto* om = static_cast<float*>(d_means3d);
    auto* osc = static_cast<float*>(d_scales);
    auto* oq = static_cast<float*>(d_quats);
    auto* osh = static_cast<float*>(d_shs);
    auto* ocov = static_cast<float*>(d_cov3d);
#define BWD(D)                                                                               \
    launch_bwd<D>(f(means3d), f(scales), f(quats), f(shs), f(cov3d_precomp), f(viewmatrix), \
                  f(projmatrix), f(campos), p, gm2, gd, gc, gcol, om, osc, oq, osh, ocov, s)
    switch (shs == nullptr ? 0 : sh_degree) {
        case 0: return BWD(0);
        case 1: return BWD(1);
        case 2: return BWD(2);
        case 3: return BWD(3);
        case 4: return BWD(4);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef BWD
}
