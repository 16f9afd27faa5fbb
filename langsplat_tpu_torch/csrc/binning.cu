// Tile binning for Hopper (sm_90a): the sorted instance buffer of ops/tiles.py
// bin_gaussians, built on the card with no host read and no [N, tmax] intermediate.
//
// Replaces no Pallas kernel: the JAX package (langsplat_tpu/ops/tiles.py:251
// bin_gaussians) leaves binning to XLA (a packed uint32 pass mask, scatter+cumsum over
// the budget axis, two sorts). The port ran it as ~40 elementwise PyTorch ops on
// [N, tmax] float32 tensors, a nonzero(), two int64 sorts and six host syncs a view:
// ~10 ms of device time a 1M-Gaussian view, about 100x its bound.
//
// Contract (ops/tiles.py bin_gaussians_plain, tile_pass_mask, instance_counts), five
// entry points, each one binding of ops/_build.Kernel and one launch counter:
//   bin_count:  per Gaussian, the instances it lists (the exact ellipse-versus-tile cull
//               of tile_pass_mask over its clipped rect, or min(rect, tmax) unculled) and
//               the tile positions lost to the cap; with a budget, also the scan of the
//               block sums: the total, num_instances, dropped, rect_dropped, all on the
//               device; and the depth sort's keys;
//   bin_rank:   the stable depth order (ties by index, invisible last) and its inverse,
//               the depth rank, by the radix sort below;
//   bin_emit:   each Gaussian's pre-sort offset (gauss_offsets) and, for each listed
//               position whose gaussian-major slot is below the budget, the key
//               [tile | depth rank] at that slot;
//   bin_sort:   the kept keys [0, num_instances) sorted over the key's used bits, the
//               sorted slots written as presort_slot;
//   bin_ranges: tile_id, gauss_id (through the depth order) and the padding sentinels out
//               to the budget; tile_start as searchsorted-left gives it.
// Every field equals the plain version bit for bit: the keys are unique, so the sorted
// order has one right answer.
//
// Numbers. The source is built with --fmad=false (ops/_build.py), so every + and *
// rounds alone, in tile_pass_mask's expression order, as the card's PyTorch runs it one
// elementwise kernel at a time: divisions are IEEE, maximum / minimum / clamp_min keep
// NaN, the threshold is -log(ALPHA_EPS) (a float argument) plus logf(max(opa, 1e-12)).
//
// What bounds it: device-memory bytes. A 1M-Gaussian view reads ~45 B a Gaussian (twice:
// count and emit), sorts ~1.5M 8-byte pairs and 1M depth keys (4 passes of 8 bits each,
// ~24 B a pair a pass) and writes the budget-sized outputs (12 B x budget): ~0.1 ms at
// 3.35 TB/s. Design against it: nothing [N, tmax]-sized exists; the cull runs in
// registers, once to count and once to emit; the sorts take only the live items (their
// count is read on the device, and blocks past it return at once) over only the key's
// used bits; each radix pass is a block histogram, a per-digit scan of the histograms
// and a stable scatter ranked in shared memory (warp match, then across warps), written
// out digit run by digit run. No atomics on device memory and no spin-waits: two runs
// give the same bits.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kRadix = 256;                 // 8-bit digits
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kRadix, "a block's threads each own one digit");

template <typename KeyT>
struct Sort {
    static constexpr int kPerThread = sizeof(KeyT) == 4 ? 16 : 12;
    static constexpr int kItems = kThreads * kPerThread;   // items a block
};

// ---------------------------------------------------------------------------
// Block-wide helpers (every thread of the block calls them)
// ---------------------------------------------------------------------------

template <int THREADS, typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* total) {
    constexpr int W = THREADS / 32;
    __shared__ T s_warp[W];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        T w = lane < W ? s_warp[lane] : T(0);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const T y = __shfl_up_sync(kFull, w, o);
            if (lane >= o) w += y;
        }
        if (lane < W) s_warp[lane] = w;
    }
    __syncthreads();
    const T before = warp ? s_warp[warp - 1] : T(0);
    if (total != nullptr) *total = s_warp[W - 1];
    __syncthreads();
    return before + x - v;
}

template <int THREADS, typename T>
__device__ __forceinline__ T block_sum(T v) {
    T total;
    block_exclusive_scan<THREADS, T>(v, &total);
    return total;
}

// ---------------------------------------------------------------------------
// The cull: tile_pass_mask's arithmetic for one (Gaussian, rect position)
// ---------------------------------------------------------------------------

struct CullArgs {
    const float* means2d;    // [N, 2]
    const float* conics;     // [N, 3]
    const int* tiles_min;    // [N, 2]
    const int* tiles_max;    // [N, 2]
    const bool* visible;     // [N]
    const float* opacities;  // [N] or null
    int n;
    float lam0;              // -log(ALPHA_EPS), rounded to float32
    float tile_size;
    int tmax;
    int cull;                // 1: the culled path (tile_size given, tmax <= MAX_CULL_TMAX)
};

// torch.maximum / torch.minimum / clamp_min on the card: NaN in, NaN out
__device__ __forceinline__ float max_nan(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
    return min_nan(max_nan(x, lo), hi);
}

struct Gauss {
    float minx, miny, mx, my, ca, cb, cc, ca_s, cc_s, lam;
    int tx0, ty0, w_raw, h_raw, w, rect;
    bool vis;
};

__device__ __forceinline__ Gauss load_gauss(const CullArgs& a, int g) {
    Gauss G;
    G.tx0 = a.tiles_min[2 * g];
    G.ty0 = a.tiles_min[2 * g + 1];
    G.w_raw = a.tiles_max[2 * g] - G.tx0;
    G.h_raw = a.tiles_max[2 * g + 1] - G.ty0;
    G.w = max(G.w_raw, 1);
    G.rect = G.w * max(G.h_raw, 1);
    G.vis = a.visible[g];
    G.lam = a.lam0;
    if (a.opacities != nullptr) G.lam = a.lam0 + logf(max_nan(a.opacities[g], 1e-12f));
    if (a.cull) {
        G.minx = static_cast<float>(G.tx0);
        G.miny = static_cast<float>(G.ty0);
        G.mx = a.means2d[2 * g];
        G.my = a.means2d[2 * g + 1];
        G.ca = a.conics[3 * g];
        G.cb = a.conics[3 * g + 1];
        G.cc = a.conics[3 * g + 2];
        G.ca_s = max_nan(G.ca, 1e-12f);
        G.cc_s = max_nan(G.cc, 1e-12f);
    }
    return G;
}

__device__ __forceinline__ float quad(const Gauss& G, float dx, float dy) {
    return 0.5f * (G.ca * dx * dx + G.cc * dy * dy) + G.cb * dx * dy;
}

// tile_pass_mask at position j < rect of a visible Gaussian's rect (rect <= tmax)
__device__ __forceinline__ bool tile_passes(const Gauss& G, int j, float ts) {
    const float tx = G.minx + static_cast<float>(j % G.w);
    const float ty = G.miny + static_cast<float>(j / G.w);
    const float x0 = tx * ts - G.mx;
    const float x1 = x0 + (ts - 1.0f);
    const float y0 = ty * ts - G.my;
    const float y1 = y0 + (ts - 1.0f);
    const bool inside = (x0 <= 0.0f) & (0.0f <= x1) & (y0 <= 0.0f) & (0.0f <= y1);
    const float ncb = -G.cb;
    const float qa = quad(G, x0, clip(ncb * x0 / G.cc_s, y0, y1));
    const float qb = quad(G, x1, clip(ncb * x1 / G.cc_s, y0, y1));
    const float qc = quad(G, clip(ncb * y0 / G.ca_s, x0, x1), y0);
    const float qd = quad(G, clip(ncb * y1 / G.ca_s, x0, x1), y1);
    float qmin = min_nan(min_nan(qa, qb), min_nan(qc, qd));
    if (inside) qmin = 0.0f;
    return qmin <= G.lam;
}

// The Gaussian's instance count and the tile positions its cap loses (instance_counts,
// and rect_dropped's term in bin_gaussians_plain)
__device__ __forceinline__ int count_of(const CullArgs& a, const Gauss& G, int* rect_drop) {
    const int full = G.vis ? G.w_raw * G.h_raw : 0;
    if (!a.cull) {
        const int c = min(full, a.tmax);
        *rect_drop = full - c;
        return max(c, 0);
    }
    const bool any_alpha = G.lam >= 0.0f;
    *rect_drop = (full > a.tmax && any_alpha) ? full - a.tmax : 0;
    if (G.rect > a.tmax) return (G.vis && any_alpha) ? a.tmax : 0;
    if (!G.vis) return 0;
    int c = 0;
    for (int j = 0; j < G.rect; ++j) c += tile_passes(G, j, a.tile_size);
    return c;
}

// torch.sort's ascending order of float32 (NaN last, -0 == +0) as unsigned order
__device__ __forceinline__ unsigned depth_key(float d) {
    if (d != d) return 0xffffffffu;
    if (d == 0.0f) d = 0.0f;
    const unsigned u = __float_as_uint(d);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// ---------------------------------------------------------------------------
// bin_count
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
binning_count_kernel(CullArgs a, const float* __restrict__ depths, int* __restrict__ counts,
                     int* __restrict__ blk_count, unsigned* __restrict__ blk_rdrop,
                     unsigned* __restrict__ depth_keys) {
    const int g = blockIdx.x * kThreads + threadIdx.x;
    int c = 0, rd = 0;
    if (g < a.n) {
        const Gauss G = load_gauss(a, g);
        c = count_of(a, G, &rd);
        counts[g] = c;
        if (depth_keys != nullptr)
            depth_keys[g] = depth_key(G.vis ? depths[g] : __int_as_float(0x7f800000));
    }
    if (blk_count == nullptr) return;           // uniform across the block
    const int sum = block_sum<kThreads, int>(c);
    const unsigned rsum = block_sum<kThreads, unsigned>(static_cast<unsigned>(rd));
    if (threadIdx.x == 0) {
        blk_count[blockIdx.x] = sum;
        blk_rdrop[blockIdx.x] = rsum;
    }
}

// one block: the block sums -> exclusive block offsets (in place), and the totals
__global__ void __launch_bounds__(kScanThreads)
binning_offsets_kernel(int* __restrict__ blk_count, const unsigned* __restrict__ blk_rdrop,
                       int blocks, int n, int budget, int* __restrict__ gauss_offsets,
                       int* __restrict__ num_instances, int* __restrict__ dropped,
                       int* __restrict__ rect_dropped) {
    const int chunk = (blocks + kScanThreads - 1) / kScanThreads;
    const int lo = min(threadIdx.x * chunk, blocks), hi = min(lo + chunk, blocks);
    int s = 0;
    unsigned rd = 0;
    for (int i = lo; i < hi; ++i) {
        s += blk_count[i];
        rd += blk_rdrop[i];
    }
    int total;
    int run = block_exclusive_scan<kScanThreads, int>(s, &total);
    const unsigned rtotal = block_sum<kScanThreads, unsigned>(rd);
    for (int i = lo; i < hi; ++i) {
        const int v = blk_count[i];
        blk_count[i] = run;
        run += v;
    }
    if (threadIdx.x == 0) {
        gauss_offsets[n] = total;
        *num_instances = min(total, budget);
        *dropped = max(total - budget, 0);
        *rect_dropped = static_cast<int>(rtotal);   // the int64 sum's low 32 bits
    }
}

// ---------------------------------------------------------------------------
// bin_emit
// ---------------------------------------------------------------------------

template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
binning_emit_kernel(CullArgs a, const int* __restrict__ counts,
                    const int* __restrict__ blk_off, const int* __restrict__ rank,
                    int grid_x, int rank_bits, int budget, KeyT* __restrict__ keys,
                    int* __restrict__ gauss_offsets) {
    const int g = blockIdx.x * kThreads + threadIdx.x;
    const int c = g < a.n ? counts[g] : 0;
    const int off = block_exclusive_scan<kThreads, int>(c, nullptr) + blk_off[blockIdx.x];
    if (g >= a.n) return;
    gauss_offsets[g] = off;
    if (c == 0 || off >= budget) return;
    const Gauss G = load_gauss(a, g);
    const KeyT r = static_cast<KeyT>(rank[g]);
    auto put = [&](int j, int slot) {
        const int tile = (G.ty0 + j / G.w) * grid_x + (G.tx0 + j % G.w);
        keys[slot] = (static_cast<KeyT>(tile) << rank_bits) | r;
    };
    if (!a.cull || G.rect > a.tmax) {           // the first c positions, unculled
        const int end = min(c, budget - off);
        for (int j = 0; j < end; ++j) put(j, off + j);
        return;
    }
    int slot = off;
    for (int j = 0; j < G.rect && slot < budget; ++j) {
        if (tile_passes(G, j, a.tile_size)) put(j, slot++);
    }
}

// ---------------------------------------------------------------------------
// The radix sort (stable, least significant digit first, 8 bits a pass). Items past the
// live count, read on the device, take no part; blocks past it return at once.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int live_count(const int* count, int capacity) {
    return count != nullptr ? min(max(*count, 0), capacity) : capacity;
}

template <typename KeyT>
__device__ __forceinline__ unsigned digit_of(KeyT key, int shift) {
    return static_cast<unsigned>((key >> shift) & KeyT(kRadix - 1));
}

// hist[d * blocks + b]: block b's items with digit d
template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const KeyT* __restrict__ keys, const int* count, int capacity, int shift,
                  int blocks, unsigned* __restrict__ hist) {
    __shared__ unsigned s_hist[kRadix];
    const int live = live_count(count, capacity);
    const int start = blockIdx.x * Sort<KeyT>::kItems;
    if (start >= live) return;
    const int end = min(start + Sort<KeyT>::kItems, live);
    s_hist[threadIdx.x] = 0;
    __syncthreads();
    for (int i = start + threadIdx.x; i < end; i += kThreads)
        atomicAdd(&s_hist[digit_of(keys[i], shift)], 1u);
    __syncthreads();
    hist[threadIdx.x * blocks + blockIdx.x] = s_hist[threadIdx.x];
}

// one block a digit: its row of the live blocks' counts -> exclusive, and its total
__global__ void __launch_bounds__(kThreads)
radix_scan_kernel(unsigned* __restrict__ hist, unsigned* __restrict__ totals,
                 const int* count, int capacity, int blocks, int items) {
    const int live = live_count(count, capacity);
    const int active = (live + items - 1) / items;
    unsigned* row = hist + static_cast<size_t>(blockIdx.x) * blocks;
    const int chunk = (active + kThreads - 1) / kThreads;
    const int lo = min(threadIdx.x * chunk, active), hi = min(lo + chunk, active);
    unsigned s = 0;
    for (int i = lo; i < hi; ++i) s += row[i];
    unsigned total;
    unsigned run = block_exclusive_scan<kThreads, unsigned>(s, &total);
    for (int i = lo; i < hi; ++i) {
        const unsigned v = row[i];
        row[i] = run;
        run += v;
    }
    if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// The stable scatter of one pass. A block's items are item = warp * (K * 32) + k * 32 +
// lane; each warp ranks its K rounds in order with __match_any_sync and per-warp digit
// counters, then the counters are scanned digit-major across warps, so the block-local
// rank follows the item order. The block stages its items sorted by digit in shared
// memory and writes each digit's run to its global offset.
template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
radix_scatter_kernel(const KeyT* __restrict__ keys_in, const int* __restrict__ vals_in,
                     KeyT* __restrict__ keys_out, int* __restrict__ vals_out,
                     int* __restrict__ inverse, const unsigned* __restrict__ hist,
                     const unsigned* __restrict__ totals, const int* count, int capacity,
                     int shift, int blocks) {
    constexpr int K = Sort<KeyT>::kPerThread;
    constexpr int kItems = Sort<KeyT>::kItems;
    struct Staged {
        KeyT keys[kItems];
        int vals[kItems];
    };
    __shared__ union {
        unsigned warp_count[kWarps][kRadix];
        Staged staged;
    } s;
    __shared__ unsigned s_start[kRadix];    // the digit's first block-local rank
    __shared__ unsigned s_global[kRadix];   // its first position in the output

    const int live = live_count(count, capacity);
    const int start = blockIdx.x * kItems;
    if (start >= live) return;
    const int here = min(kItems, live - start);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lower = (1u << lane) - 1u;

    for (int i = threadIdx.x; i < kWarps * kRadix; i += kThreads)
        (&s.warp_count[0][0])[i] = 0;
    const unsigned base = block_exclusive_scan<kThreads, unsigned>(totals[threadIdx.x],
                                                                   nullptr);
    s_global[threadIdx.x] = base + hist[threadIdx.x * blocks + blockIdx.x];
    __syncthreads();

    KeyT key[K];
    int val[K];
    unsigned rank[K];
    unsigned dig[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int item = warp * (K * 32) + k * 32 + lane;
        const bool valid = item < here;
        key[k] = valid ? keys_in[start + item] : KeyT(0);
        val[k] = valid ? (vals_in != nullptr ? vals_in[start + item] : start + item) : 0;
        const unsigned d = valid ? digit_of(key[k], shift) : unsigned(kRadix);
        const unsigned peers = __match_any_sync(kFull, d);
        const unsigned before = valid ? s.warp_count[warp][d] : 0u;
        __syncwarp();
        if (valid && (peers & lower) == 0) s.warp_count[warp][d] += __popc(peers);
        __syncwarp();
        rank[k] = before + __popc(peers & lower);
        dig[k] = d;
    }
    __syncthreads();
    unsigned run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const unsigned c = s.warp_count[w][threadIdx.x];
        s.warp_count[w][threadIdx.x] = run;
        run += c;
    }
    s_start[threadIdx.x] = block_exclusive_scan<kThreads, unsigned>(run, nullptr);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (dig[k] < kRadix) rank[k] += s_start[dig[k]] + s.warp_count[warp][dig[k]];
    }
    __syncthreads();                        // the counters' space becomes the staging
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (dig[k] < kRadix) {
            s.staged.keys[rank[k]] = key[k];
            s.staged.vals[rank[k]] = val[k];
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < here; i += kThreads) {
        const KeyT kk = s.staged.keys[i];
        const unsigned d = digit_of(kk, shift);
        const int pos = static_cast<int>(s_global[d] + (i - s_start[d]));
        const int v = s.staged.vals[i];
        if (keys_out != nullptr) keys_out[pos] = kk;
        vals_out[pos] = v;
        if (inverse != nullptr) inverse[v] = pos;
    }
}

int blocks_for(long long items, int per_block) {
    return static_cast<int>((items + per_block - 1) / per_block);
}

int radix_passes(int bits) { return bits <= 8 ? 1 : (bits + 7) / 8; }

// Sort (key, value) pairs [0, live) over `bits` key bits. Keys ping-pong between keys_a
// (the input) and keys_b, values between vals_a and vals_b; the first pass takes the
// item's index as its value; the last writes the values to vals_out, its positions by
// value to `inverse` (if given) and its keys (to keys_b after an odd number of passes,
// keys_a after an even one) only if keep_keys.
template <typename KeyT>
int radix_sort(KeyT* keys_a, KeyT* keys_b, int* vals_a, int* vals_b, int* vals_out,
               int* inverse, bool keep_keys, const int* count, int capacity, int bits,
               unsigned* hist, unsigned* totals, cudaStream_t stream) {
    const int blocks = blocks_for(capacity, Sort<KeyT>::kItems);
    if (blocks == 0) return static_cast<int>(cudaGetLastError());
    const int passes = radix_passes(bits);
    for (int p = 0; p < passes; ++p) {
        const bool last = p == passes - 1;
        const KeyT* kin = p % 2 == 0 ? keys_a : keys_b;
        KeyT* kout = p % 2 == 0 ? keys_b : keys_a;
        if (last && !keep_keys) kout = nullptr;
        const int* vin = p == 0 ? nullptr : ((p - 1) % 2 == 0 ? vals_a : vals_b);
        int* vout = last ? vals_out : (p % 2 == 0 ? vals_a : vals_b);
        radix_hist_kernel<KeyT><<<blocks, kThreads, 0, stream>>>(kin, count, capacity,
                                                                 8 * p, blocks, hist);
        radix_scan_kernel<<<kRadix, kThreads, 0, stream>>>(hist, totals, count, capacity,
                                                          blocks, Sort<KeyT>::kItems);
        radix_scatter_kernel<KeyT><<<blocks, kThreads, 0, stream>>>(
            kin, vin, kout, vout, last ? inverse : nullptr, hist, totals, count, capacity,
            8 * p, blocks);
    }
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bin_ranges
// ---------------------------------------------------------------------------

template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
binning_ranges_kernel(const KeyT* __restrict__ keys, const int* __restrict__ by_depth,
                      const int* __restrict__ num_instances, int budget, int rank_bits,
                      int num_tiles, int n, int* __restrict__ tile_id,
                      int* __restrict__ gauss_id, int* __restrict__ presort_slot,
                      int* __restrict__ tile_start) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const int num = *num_instances;
    const KeyT mask = (KeyT(1) << rank_bits) - 1;
    if (i < budget) {
        if (i < num) {
            const KeyT k = keys[i];
            tile_id[i] = static_cast<int>(k >> rank_bits);
            gauss_id[i] = by_depth[static_cast<int>(k & mask)];
        } else {
            tile_id[i] = num_tiles;
            gauss_id[i] = n;
            presort_slot[i] = budget;
        }
    }
    if (i <= num) {   // tiles (prev, cur] start at i; past the last instance, num_tiles
        const int prev = i == 0 ? -1 : static_cast<int>(keys[i - 1] >> rank_bits);
        const int cur = i < num ? static_cast<int>(keys[i] >> rank_bits) : num_tiles;
        for (int t = prev + 1; t <= cur; ++t) tile_start[t] = i;
    }
}

CullArgs cull_args(const void* means2d, const void* conics, const void* tiles_min,
                   const void* tiles_max, const void* visible, const void* opacities, int n,
                   float lam0, float tile_size, int tmax, int cull) {
    return CullArgs{static_cast<const float*>(means2d), static_cast<const float*>(conics),
                    static_cast<const int*>(tiles_min), static_cast<const int*>(tiles_max),
                    static_cast<const bool*>(visible), static_cast<const float*>(opacities),
                    n, lam0, tile_size, tmax, cull};
}

// The wrapper's one int32 scratch buffer (ops/tiles.py bin_gaussians_cuda), carved here
// for n Gaussians and `budget` instances; every piece starts at an even word, so the
// 64-bit keys are aligned.
struct Scratch {
    int* counts;             // [n] instances a Gaussian
    int* blk_count;          // [blocks] their block sums, then the blocks' offsets
    unsigned* blk_rdrop;     // [blocks] rect positions dropped, block sums
    unsigned* depth_keys;    // [n] the depth sort: keys, ping-pong keys and values
    unsigned* depth_tmp;
    int* depth_vals_a;
    int* depth_vals_b;
    int* by_depth;           // [n] Gaussians in depth order
    int* rank;               // [n] each Gaussian's depth rank
    unsigned* hist;          // [256 + 256 x sort blocks] the sorts' digit totals, histograms
    void* keys_a;            // [budget] the instance sort: keys (4 or 8 bytes), values
    void* keys_b;
    int* vals_a;
    int* vals_b;
    long long words;
};

Scratch carve(void* base, int n, int budget, int key64) {
    auto* w = static_cast<int*>(base);
    long long at = 0;
    auto take = [&](long long words) {
        int* p = w != nullptr ? w + at : nullptr;
        at += words + words % 2;
        return p;
    };
    const int blocks = blocks_for(n, kThreads);
    const int key_words = key64 ? 2 : 1;
    const int items = key64 ? Sort<uint64_t>::kItems : Sort<unsigned>::kItems;
    const int sort_blocks = std::max(blocks_for(n, Sort<unsigned>::kItems),
                                     blocks_for(budget, items));
    Scratch sc;
    sc.counts = take(n);
    sc.blk_count = take(blocks);
    sc.blk_rdrop = reinterpret_cast<unsigned*>(take(blocks));
    sc.depth_keys = reinterpret_cast<unsigned*>(take(n));
    sc.depth_tmp = reinterpret_cast<unsigned*>(take(n));
    sc.depth_vals_a = take(n);
    sc.depth_vals_b = take(n);
    sc.by_depth = take(n);
    sc.rank = take(n);
    sc.hist = reinterpret_cast<unsigned*>(take(kRadix * (1LL + sort_blocks)));
    sc.keys_a = take(static_cast<long long>(key_words) * budget);
    sc.keys_b = take(static_cast<long long>(key_words) * budget);
    sc.vals_a = take(budget);
    sc.vals_b = take(budget);
    sc.words = at;
    return sc;
}

}  // namespace

// C entry points for ctypes. Each launching one returns cudaGetLastError() after its
// launches (0 = success); the stream is the caller's current stream. Sizes: n Gaussians,
// `budget` instances; `scratch` is the wrapper's buffer of bin_scratch_words(n, budget,
// key64) int32 words, which the five entry points of one binning share.

extern "C" long long bin_scratch_words(int n, int budget, int key64) {
    return carve(nullptr, n, budget, key64).words;
}

// With `scratch`, the counts, their block scan and the totals (gauss_offsets[n],
// num_instances, dropped, rect_dropped) and the depth sort's keys; without it, only the
// counts, into `counts` (instance_counts).
extern "C" int bin_count(const void* means2d, const void* conics, const void* tiles_min,
                         const void* tiles_max, const void* visible, const void* opacities,
                         const void* depths, int n, float lam0, float tile_size, int tmax,
                         int cull, int budget, int key64, void* scratch, void* counts,
                         void* gauss_offsets, void* num_instances, void* dropped,
                         void* rect_dropped, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    const CullArgs a = cull_args(means2d, conics, tiles_min, tiles_max, visible, opacities,
                                 n, lam0, tile_size, tmax, cull);
    const int blocks = blocks_for(n, kThreads);
    if (scratch == nullptr) {
        if (blocks > 0) {
            binning_count_kernel<<<blocks, kThreads, 0, s>>>(
                a, nullptr, static_cast<int*>(counts), nullptr, nullptr, nullptr);
        }
        return static_cast<int>(cudaGetLastError());
    }
    const Scratch sc = carve(scratch, n, budget, key64);
    if (blocks > 0) {
        binning_count_kernel<<<blocks, kThreads, 0, s>>>(
            a, static_cast<const float*>(depths), sc.counts, sc.blk_count, sc.blk_rdrop,
            sc.depth_keys);
    }
    binning_offsets_kernel<<<1, kScanThreads, 0, s>>>(
        sc.blk_count, sc.blk_rdrop, blocks, n, budget, static_cast<int*>(gauss_offsets),
        static_cast<int*>(num_instances), static_cast<int*>(dropped),
        static_cast<int*>(rect_dropped));
    return static_cast<int>(cudaGetLastError());
}

extern "C" int bin_rank(void* scratch, int n, int budget, int key64, void* stream) {
    const Scratch sc = carve(scratch, n, budget, key64);
    return radix_sort<unsigned>(sc.depth_keys, sc.depth_tmp, sc.depth_vals_a,
                                sc.depth_vals_b, sc.by_depth, sc.rank, false, nullptr, n,
                                32, sc.hist + kRadix, sc.hist,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int bin_emit(const void* means2d, const void* conics, const void* tiles_min,
                        const void* tiles_max, const void* visible, const void* opacities,
                        int n, float lam0, float tile_size, int tmax, int cull, int budget,
                        int key64, void* scratch, int grid_x, int rank_bits,
                        void* gauss_offsets, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    const CullArgs a = cull_args(means2d, conics, tiles_min, tiles_max, visible, opacities,
                                 n, lam0, tile_size, tmax, cull);
    const int blocks = blocks_for(n, kThreads);
    if (blocks == 0) return static_cast<int>(cudaGetLastError());
    const Scratch sc = carve(scratch, n, budget, key64);
    auto* go = static_cast<int*>(gauss_offsets);
    if (key64) {
        binning_emit_kernel<uint64_t><<<blocks, kThreads, 0, s>>>(
            a, sc.counts, sc.blk_count, sc.rank, grid_x, rank_bits, budget,
            static_cast<uint64_t*>(sc.keys_a), go);
    } else {
        binning_emit_kernel<unsigned><<<blocks, kThreads, 0, s>>>(
            a, sc.counts, sc.blk_count, sc.rank, grid_x, rank_bits, budget,
            static_cast<unsigned*>(sc.keys_a), go);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int bin_sort(void* scratch, int n, int budget, int key64, int bits,
                        const void* num_instances, void* presort_slot, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    const Scratch sc = carve(scratch, n, budget, key64);
    const auto* count = static_cast<const int*>(num_instances);
    auto* out = static_cast<int*>(presort_slot);
    if (key64) {
        return radix_sort<uint64_t>(static_cast<uint64_t*>(sc.keys_a),
                                    static_cast<uint64_t*>(sc.keys_b), sc.vals_a, sc.vals_b,
                                    out, nullptr, true, count, budget, bits,
                                    sc.hist + kRadix, sc.hist, s);
    }
    return radix_sort<unsigned>(static_cast<unsigned*>(sc.keys_a),
                                static_cast<unsigned*>(sc.keys_b), sc.vals_a, sc.vals_b, out,
                                nullptr, true, count, budget, bits, sc.hist + kRadix,
                                sc.hist, s);
}

extern "C" int bin_ranges(void* scratch, int n, int budget, int key64, int bits,
                          int rank_bits, int num_tiles, const void* num_instances,
                          void* tile_id, void* gauss_id, void* presort_slot,
                          void* tile_start, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    const Scratch sc = carve(scratch, n, budget, key64);
    const void* keys = radix_passes(bits) % 2 ? sc.keys_b : sc.keys_a;   // bin_sort's last
    const int blocks = blocks_for(static_cast<long long>(budget) + 1, kThreads);
    const auto* num = static_cast<const int*>(num_instances);
    auto* ti = static_cast<int*>(tile_id);
    auto* gi = static_cast<int*>(gauss_id);
    auto* ps = static_cast<int*>(presort_slot);
    auto* ts = static_cast<int*>(tile_start);
    if (key64) {
        binning_ranges_kernel<uint64_t><<<blocks, kThreads, 0, s>>>(
            static_cast<const uint64_t*>(keys), sc.by_depth, num, budget, rank_bits,
            num_tiles, n, ti, gi, ps, ts);
    } else {
        binning_ranges_kernel<unsigned><<<blocks, kThreads, 0, s>>>(
            static_cast<const unsigned*>(keys), sc.by_depth, num, budget, rank_bits,
            num_tiles, n, ti, gi, ps, ts);
    }
    return static_cast<int>(cudaGetLastError());
}
