// Adam over every parameter group of one update, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves Adam (langsplat_tpu/train/trainer.py,
// optax.multi_transform of optax.adam per group) to XLA. The port ran it as ~18 launches
// a group (train/trainer.py adam_direction on one-tensor lists: the moments' foreach
// passes, the bias corrections' scalars, the direction's divides and square root), two
// more full passes for the -lr scale and the parameter add, and a new full-size
// intermediate at every pass. Here one launch takes every group of the update.
//
// Contract (train/trainer.py Adam.update_plain, per group, on float32 tensors of n
// elements; b1 0.9, b2 0.999, eps outside the square root, as optax.scale_by_adam):
//   mu' = g*(1-b1) + mu*b1;  nu' = (g*g)*(1-b2) + nu*b2;  c = float(count + 1);
//   step = (mu'/(1 - b1^c)) / (sqrt(nu'/(1 - b2^c)) + eps);  param' = param + step*(-lr),
// with lr the group's constant or, for a scheduled group, the float32 rate the schedule
// left on the device. Out of place: param', mu', nu' and count + 1 (and the schedule's
// count + 1) go to outputs of their own, and the inputs are left as they were, so a
// discarded step can be run again from them. An input may be row-strided: rows of `row`
// contiguous elements, `stride` elements apart (a gradient that autograd hands out as a
// slice of a concatenation's, a data-parallel shard's column block); outputs are
// contiguous.
//
// Numbers. The source is built with --fmad=false (ops/_build.py), so every + and *
// rounds alone; / and sqrtf are IEEE-rounded (nvcc's defaults). The constants come as
// the float32 roundings of the Python constants, as torch rounds a wrapped scalar. Each
// element takes the plain version's float32 operations in its order, so param', mu' and
// nu' are bit-equal to it on the card.
//
// What bounds it: device-memory bytes. An element reads param, grad, mu and nu and
// writes param', mu' and nu': 28 B. A phase-A step at 1M Gaussians (59 floats each)
// moves 1.65 GB, 0.49 ms at 3.35 TB/s; a handful of FP32 operations and three IEEE
// divisions an element are far below the compute bound. Design against it: one block
// takes one chunk of kChunk elements of one group (a prefix of chunk counts in the
// table maps blocks to groups); every thread loads its kItems elements of each input
// before it computes, so that 4 x kItems loads are in flight a thread, consecutive
// threads reading consecutive elements of a row; each thread steps its row and column
// by kThreads elements (two divisions a thread), so a row-strided input costs no copy.
// The table is a __grid_constant__ kernel parameter: no upload and no sync.

#include <cuda_runtime.h>

#include <climits>

// One parameter group, as train/trainer.py _AdamGroup lays it out.
struct AdamGroup {
    const float* param;
    const float* grad;
    const float* mu;
    const float* nu;
    float* param_out;
    float* mu_out;
    float* nu_out;
    const int* count;
    int* count_out;
    const int* sched_count;     // null where the learning rate is constant
    int* sched_count_out;
    const float* rate;          // the schedule's learning rate, or null: neg_lr below
    long long n;
    long long row;              // elements a row: n / rows
    long long stride[4];        // the row stride of param, grad, mu and nu, in elements
    float neg_lr;               // -lr, rounded to float32
};

namespace {

constexpr int kMaxGroups = 8;
constexpr int kThreads = 256;
constexpr int kItems = 16;                                // elements a thread and chunk
constexpr long long kChunk = static_cast<long long>(kItems) * kThreads;  // a block

struct Table {
    AdamGroup g[kMaxGroups];
    long long first[kMaxGroups];    // the first block of each group
    int n;
};

struct Betas {
    float b1, one_minus_b1, b2, one_minus_b2, eps;
};

// The per-block constants of a group: the bias corrections at count + 1 and -lr.
struct Scale {
    float bc1, bc2, neg_lr;
};

__device__ __forceinline__ void adam(float& p, float g, float& m, float& v, const Betas& k,
                                     const Scale& s) {
    m = g * k.one_minus_b1 + m * k.b1;
    v = (g * g) * k.one_minus_b2 + v * k.b2;
    const float step = (m / s.bc1) / (sqrtf(v / s.bc2) + k.eps);
    p = p + step * s.neg_lr;
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ Table t, const Betas k) {
    int gi = 0;
    while (gi + 1 < t.n && static_cast<long long>(blockIdx.x) >= t.first[gi + 1]) ++gi;
    const AdamGroup& G = t.g[gi];
    const long long chunk = blockIdx.x - t.first[gi];
    const int count = *G.count;
    const float c = static_cast<float>(count + 1);
    const Scale s{1.0f - powf(k.b1, c), 1.0f - powf(k.b2, c),
                  G.rate != nullptr ? -*G.rate : G.neg_lr};
    if (chunk == 0 && threadIdx.x == 0) {
        *G.count_out = count + 1;
        if (G.sched_count != nullptr) *G.sched_count_out = *G.sched_count + 1;
    }
    const long long begin = chunk * kChunk;
    const long long end = G.n < begin + kChunk ? G.n : begin + kChunk;
    const float* __restrict__ pin = G.param;
    const float* __restrict__ gin = G.grad;
    const float* __restrict__ muin = G.mu;
    const float* __restrict__ nuin = G.nu;
    float* __restrict__ pout = G.param_out;
    float* __restrict__ mout = G.mu_out;
    float* __restrict__ vout = G.nu_out;
    // element e of the group is row r, column col; input x reads r * stride[x] + col
    const long long e0 = begin + threadIdx.x;
    const long long rows_step = kThreads / G.row, cols_step = kThreads % G.row;
    long long r = e0 / G.row, col = e0 - r * G.row;
    float P[kItems], Gr[kItems], M[kItems], V[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        if (e0 + j * kThreads < end) {
            P[j] = pin[r * G.stride[0] + col];
            Gr[j] = gin[r * G.stride[1] + col];
            M[j] = muin[r * G.stride[2] + col];
            V[j] = nuin[r * G.stride[3] + col];
        }
        r += rows_step;
        col += cols_step;
        if (col >= G.row) {
            col -= G.row;
            ++r;
        }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const long long e = e0 + j * kThreads;
        if (e < end) {
            adam(P[j], Gr[j], M[j], V[j], k, s);
            pout[e] = P[j];
            mout[e] = M[j];
            vout[e] = V[j];
        }
    }
}

}  // namespace

// One launch over `n_groups` groups (1 to kMaxGroups); every group takes at least one
// block, which writes its counts, so an empty group still counts its update.
extern "C" int adam_update(const AdamGroup* groups, int n_groups, float b1,
                           float one_minus_b1, float b2, float one_minus_b2, float eps,
                           void* stream) {
    if (n_groups < 1 || n_groups > kMaxGroups)
        return static_cast<int>(cudaErrorInvalidValue);
    Table t{};
    t.n = n_groups;
    long long blocks = 0;
    for (int i = 0; i < n_groups; ++i) {
        const AdamGroup& g = groups[i];
        if (g.n < 0 || g.row < 1 || g.n % g.row != 0 || g.count == nullptr ||
            g.count_out == nullptr ||
            (g.sched_count == nullptr) != (g.sched_count_out == nullptr))
            return static_cast<int>(cudaErrorInvalidValue);
        t.g[i] = g;
        t.first[i] = blocks;
        blocks += g.n > 0 ? (g.n + kChunk - 1) / kChunk : 1;
    }
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        t, Betas{b1, one_minus_b1, b2, one_minus_b2, eps});
    return static_cast<int>(cudaGetLastError());
}
