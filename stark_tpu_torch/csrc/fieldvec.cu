// GF(p) vector kernels for Hopper: inversion, prefix product, power table
// and one elementwise Montgomery operation (K7-K10).
//
// In the JAX package these are XLA-fused device functions with no Pallas
// form, used by device trace interpolation and the boundary quotients of
// Stark._prove_device (stark_tpu/ops/geometric_device.py, stark.py):
//
//   K7  stark_mont_inv         a^-1, 0 -> 0: field_ops.mont_inv
//                              (stark_tpu/ops/field_ops.py:432, :333)
//   K8  stark_prefix_mul       inclusive prefix product along the columns:
//                              geometric_device.prefix_mont_mul (:48)
//   K9  stark_geometric_table  start * base^i, i < n, from the bit bases
//                              base^(2^b): device_prover.geometric_table
//                              (stark_tpu/ops/device_prover.py:226)
//   K10 stark_mont_binary      a * b, a + b or a - b elementwise, either
//                              operand an (8, 1) column broadcast along n:
//                              field_ops.mont_mul / add / sub
//       stark_mont_outer       its row-by-column form: out[i * c + j] =
//                              a[i] * b[j], the separable tables of the
//                              four-step layout (stark_tpu/parallel/
//                              fold_sharded.py, stark_sharded.py: a row
//                              table times a column table)
//
// Every element is a Montgomery value (R = 2^128) in the (8, n) 16-bit
// limb layout, loaded and stored with field.cuh's helpers.  Field products
// are exact, commutative and associative, and the inverse is unique, so
// any order of products (a scan's, an addition chain's) gives the same
// limbs as the plain PyTorch versions.
//
// Bounds on the card.  Each function moves 32-96 bytes an element and
// needs at most ~3 products an element (an inversion, by Montgomery's batch
// inversion; 1 for the others), so all four are bound by memory at
// 3.35 TB/s.  What each design does about it:
//   K7  Montgomery's batch inversion inside each block of kInvChunk
//       elements, in one launch: a thread's run of products, the prefix
//       and suffix products of each warp's run totals, one Fermat chain
//       (131 squarings, 31 multiplies) a warp, the 8 of a block side by
//       side, then each run swept backwards; ~4 products an element and
//       no global scratch.  A block waits one chain's latency.
//   K8  one launch: a tile of kScanChunk elements a block, scanned in
//       registers and by warp shuffles, the tiles chained by a decoupled
//       look-back over a status buffer the caller keeps (~2 products an
//       element, no pass over the output again).
//   K9  a thread raises the base to its first index by the bit bases,
//       then steps by base^T, T the threads of the grid: ~2 products an
//       element at 2^20, stores coalesced.
//   K10 one element a thread.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using stark::Fe;
using stark::fe_mul;

constexpr int kThreads = 256;
constexpr int kScanItems = 4;                      // consecutive elements a thread scans
constexpr int kScanChunk = kThreads * kScanItems;  // elements a scan tile holds
constexpr int kLookItems = 4;                      // tiles a lane checks in one look-back window
constexpr int kMaxBits = 64;                       // bit bases K9 takes

enum Op { kMul = 0, kAdd = 1, kSub = 2 };

// R mod p, the Montgomery form of 1.
__device__ __forceinline__ Fe mont_one() { return Fe{{0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x347FFFFFu}}; }

__device__ __forceinline__ int64_t global_index() {
    return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}

template <int kSquarings>
__device__ __forceinline__ Fe square_times(Fe x) {
#pragma unroll
    for (int k = 0; k < kSquarings; ++k) x = fe_mul(x, x);
    return x;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) { return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0u; }

// ---------------------------------------------------------------------------
// The one-element Fermat chain, x^(p-2) with p - 2 = 406 * 2^119 +
// (2^119 - 1): x^406 by its bits, then 23 windows of five ones and one of
// four: acc <- acc^32 * x^31, and acc^16 * x^15 last.  131 squarings and
// 31 multiplies, in registers; its window loop holds nothing but products.
// ---------------------------------------------------------------------------

__device__ __forceinline__ Fe fe_inv(const Fe& x) {
    const Fe x2 = fe_mul(x, x);
    const Fe x3 = fe_mul(x2, x);
    const Fe x15 = fe_mul(square_times<2>(x3), x3);  // x^12 * x^3
    const Fe x31 = fe_mul(fe_mul(x15, x15), x);       // x^30 * x
    // x^406, 406 = 0b110010110: from the top bit down, square, times x at a one
    Fe acc = x;
    constexpr int kHead = 406;
#pragma unroll
    for (int b = 7; b >= 0; --b) {
        acc = fe_mul(acc, acc);
        if ((kHead >> b) & 1) acc = fe_mul(acc, x);
    }
#pragma unroll 1
    for (int w = 0; w < 23; ++w) acc = fe_mul(square_times<5>(acc), x31);
    return fe_mul(square_times<4>(acc), x15);
}

// ---------------------------------------------------------------------------
// K7: Montgomery's batch inversion, a block a chunk of kInvChunk elements,
// one inverse a warp.  The chunk is read coalesced into shared memory
// (past n: one).  A thread takes its run of kInvItems consecutive
// elements, zeros as one (a bit mask keeps where they were), and
// multiplies out the run's prefixes R_0, R_1, ... in registers.  Each warp
// scans its 32 run totals both ways at once with shuffles (5 rounds), so a
// thread has the product E of the warp's runs before its own and S of
// those after, and the warp's total W; lanes 0-7 of warp 0 invert the 8
// warp totals by the Fermat chain side by side, on the vector pipes.  Then
// acc = W^-1 * E * S is the inverse of the run's product, and from the
// run's end down out_k = acc * R_{k-1}, acc <- acc * a_k, out_0 = acc;
// zeros are written as zero.  The results go back through shared memory,
// stored coalesced.  A block waits for one chain's latency, not its
// instructions; kInvBlocksPerSM resident blocks (64 registers a thread)
// take a 2^20 inversion in one wave, so its blocks wait for it together.
// ---------------------------------------------------------------------------

constexpr int kInvItems = 8;                     // consecutive elements a thread inverts
constexpr int kInvChunk = kThreads * kInvItems;  // elements a block inverts
constexpr int kWarps = kThreads / 32;
constexpr int kInvBlocksPerSM = 4;
constexpr unsigned kAll = 0xFFFFFFFFu;

__device__ __forceinline__ Fe shfl_up(const Fe& a, int d) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = __shfl_up_sync(kAll, a.w[k], d);
    return r;
}

__device__ __forceinline__ Fe shfl_down(const Fe& a, int d) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = __shfl_down_sync(kAll, a.w[k], d);
    return r;
}

__global__ void __launch_bounds__(kThreads, kInvBlocksPerSM)
    inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t n) {
    __shared__ Fe items[kInvChunk];
    __shared__ Fe warp_total[kWarps];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kInvChunk;
    const int t = threadIdx.x;
    const int lane = t % 32;
    const Fe one = mont_one();
#pragma unroll
    for (int k = 0; k < kInvItems; ++k) {
        const int64_t i = base + k * kThreads + t;
        items[k * kThreads + t] = i < n ? stark::fe_load(a, n, i) : one;
    }
    __syncthreads();
    Fe* const mine = items + t * kInvItems;
    Fe run[kInvItems];
    unsigned zeros = 0;
#pragma unroll
    for (int k = 0; k < kInvItems; ++k) {
        const bool zero = fe_is_zero(mine[k]);
        const Fe v = zero ? one : mine[k];
        zeros |= static_cast<unsigned>(zero) << k;
        run[k] = k == 0 ? v : fe_mul(run[k - 1], v);
    }
    // inclusive prefix and suffix products of the warp's run totals
    Fe before = run[kInvItems - 1];
    Fe after = before;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Fe b = shfl_up(before, d);
        const Fe s = shfl_down(after, d);
        if (lane >= d) before = fe_mul(b, before);
        if (lane + d < 32) after = fe_mul(after, s);
    }
    if (lane == 31) warp_total[t / 32] = before;
    const Fe e = shfl_up(before, 1);  // exclusive: the runs before this one
    const Fe s = shfl_down(after, 1);  // and after it
    __syncthreads();
    if (t < kWarps) warp_total[t] = fe_inv(warp_total[t]);
    __syncthreads();
    Fe acc = warp_total[t / 32];
    if (lane > 0) acc = fe_mul(acc, e);
    if (lane < 31) acc = fe_mul(acc, s);
    const Fe zero{};
#pragma unroll
    for (int k = kInvItems - 1; k > 0; --k) {
        const bool is_zero = (zeros >> k) & 1u;
        const Fe v = is_zero ? one : mine[k];
        const Fe inv = fe_mul(acc, run[k - 1]);
        mine[k] = is_zero ? zero : inv;
        acc = fe_mul(acc, v);
    }
    mine[0] = (zeros & 1u) ? zero : acc;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kInvItems; ++k) {
        const int64_t i = base + k * kThreads + t;
        if (i < n) stark::fe_store(out, n, i, items[k * kThreads + t]);
    }
}

// ---------------------------------------------------------------------------
// K8: inclusive prefix product in one launch, by decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", the design of CUB's single-pass scan).  A block takes the
// tile of kScanChunk elements its ticket names (an atomic counter, so a
// block only ever waits on tiles that blocks already running hold),
// reads it coalesced into shared memory (past n: one), and scans it: a
// thread multiplies out its run of kScanItems consecutive elements in
// registers, each warp scans its 32 run totals with shuffles, warp 0 the
// 8 warp totals.  Thread 0 publishes the tile's aggregate (state A); warp
// 0 then looks back over the statuses of the 32 * kLookItems tiles before
// it at a time (kLookItems consecutive tiles a lane), waits while any has
// published nothing, multiplies the aggregates back to the nearest tile
// that has published its inclusive prefix (state P) and that prefix,
// window after window until it meets a P, and publishes the tile's own
// inclusive prefix.  Each thread multiplies its
// run by the tile's exclusive prefix times its own in the tile, and the
// tile is stored coalesced through shared memory.  Tile 0 publishes P at
// once.
//
// A status is a flag word (epoch << 2 | state) and an aggregate and an
// inclusive prefix in separate arrays.  The writer stores the value, then
// the flag with st.release.gpu; the reader loads the flag with
// ld.acquire.gpu, then the value through L2 (__ldcg): L1 is not coherent,
// and the buffer is reused across calls, so an SM may hold a line of an
// earlier call.
//
// Bound: bytes (32 in and 32 out an element).  What holds it back at the
// prove's sizes is latency: a tile's chain of dependent products (its run,
// the warp and block scans, the look-back's reduction, the run's update)
// and the look-back's round trips through L2.  Runs of 4 and windows of
// 4 tiles a lane keep both short: at 2^17 elements every tile finds tile
// 0's P in its first window.  The caller keeps one
// zeroed status buffer a device and passes a new epoch each call, so a
// flag of an earlier call reads as "nothing published" and no launch
// resets the buffer, and the ticket count at the call's start (`base`).
// So two streams must not run this on one device at once.
// ---------------------------------------------------------------------------

enum TileState : uint32_t { kNothing = 0, kAggregate = 1, kPrefix = 2 };

__device__ __forceinline__ void store_cg(Fe* p, const Fe& v) {
    __stcg(reinterpret_cast<uint4*>(p), make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]));
}

__device__ __forceinline__ Fe load_cg(const Fe* p) {
    const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p));
    return Fe{{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Store v, then the flag that makes it visible.
__device__ __forceinline__ void publish(uint32_t* flag, Fe* slot, const Fe& v, uint32_t word) {
    store_cg(slot, v);
    store_release(flag, word);
}

__device__ __forceinline__ Fe shfl_idx(const Fe& a, int src) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = __shfl_sync(kAll, a.w[k], src);
    return r;
}

__device__ __forceinline__ Fe shfl_xor(const Fe& a, int d) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) r.w[k] = __shfl_xor_sync(kAll, a.w[k], d);
    return r;
}

__global__ void __launch_bounds__(kThreads) scan_kernel(const int32_t* in, int32_t* out, int64_t n,
                                                        unsigned long long* ticket, uint32_t* flags, Fe* aggregates,
                                                        Fe* inclusives, uint32_t epoch, unsigned long long base) {
    __shared__ Fe items[kScanChunk];
    __shared__ Fe warp_before[kWarps];  // the product of the tile's warps before each
    __shared__ Fe tile_before;          // the product of the tiles before this one
    __shared__ int64_t tile_index;
    const int t = threadIdx.x;
    const int lane = t % 32;
    const int warp = t / 32;
    const Fe one = mont_one();
    if (t == 0) tile_index = static_cast<int64_t>(atomicAdd(ticket, 1ull) - base);
    __syncthreads();
    const int64_t tile = tile_index;
    const int64_t start = tile * kScanChunk;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
        const int64_t i = start + k * kThreads + t;
        items[k * kThreads + t] = i < n ? stark::fe_load(in, n, i) : one;
    }
    __syncthreads();
    Fe* const mine = items + t * kScanItems;
    Fe run[kScanItems];
    run[0] = mine[0];
#pragma unroll
    for (int k = 1; k < kScanItems; ++k) run[k] = fe_mul(run[k - 1], mine[k]);
    // inclusive scan of the warp's run totals; e: the runs before this one
    Fe incl = run[kScanItems - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const Fe b = shfl_up(incl, d);
        if (lane >= d) incl = fe_mul(b, incl);
    }
    const Fe e = shfl_up(incl, 1);
    if (lane == 31) warp_before[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        // the 8 warp totals, scanned; lane 7 holds the tile's aggregate
        Fe w = lane < kWarps ? warp_before[lane] : one;
#pragma unroll
        for (int d = 1; d < kWarps; d <<= 1) {
            const Fe b = shfl_up(w, d);
            if (lane >= d) w = fe_mul(b, w);
        }
        const Fe before = shfl_up(w, 1);
        if (lane < kWarps) warp_before[lane] = lane > 0 ? before : one;
        const Fe aggregate = shfl_idx(w, kWarps - 1);
        if (lane == 0) {  // tile 0's aggregate is its inclusive prefix
            publish(flags + tile, (tile == 0 ? inclusives : aggregates) + tile, aggregate,
                    epoch << 2 | (tile == 0 ? kPrefix : kAggregate));
        }
        Fe exclusive = one;
        // a window: the tiles last - d, d = lane * kLookItems + k, k < kLookItems
        for (int64_t last = tile - 1; last >= 0; last -= 32 * kLookItems) {
            const int64_t first = last - lane * kLookItems;
            uint32_t state[kLookItems];
            bool waiting;
            do {
                waiting = false;
#pragma unroll
                for (int k = 0; k < kLookItems; ++k) {
                    state[k] = kPrefix;  // before tile 0: nothing to wait for (tile 0's P stops the look-back first)
                    if (first - k >= 0) {
                        const uint32_t f = load_acquire(flags + first - k);
                        state[k] = (f >> 2) == epoch ? (f & 3u) : static_cast<uint32_t>(kNothing);
                    }
                    waiting |= state[k] == kNothing;
                }
            } while (__any_sync(kAll, waiting));
            int nearest = kLookItems;  // this lane's nearest P
#pragma unroll
            for (int k = kLookItems - 1; k >= 0; --k) {
                if (state[k] == kPrefix) nearest = k;
            }
            const unsigned prefixes = __ballot_sync(kAll, nearest < kLookItems);
            const int stop = prefixes ? __ffs(prefixes) - 1 : 31;  // lanes 0 .. stop take part, lane stop to its P
            Fe x[kLookItems];  // the lane's tiles that take part, as a product tree
#pragma unroll
            for (int k = 0; k < kLookItems; ++k) {
                const int64_t j = first - k;
                const bool part = j >= 0 && (lane < stop || (lane == stop && k <= nearest));
                x[k] = part ? load_cg(state[k] == kPrefix ? inclusives + j : aggregates + j) : one;
            }
#pragma unroll
            for (int h = 1; h < kLookItems; h <<= 1) {
#pragma unroll
                for (int k = 0; k + h < kLookItems; k += 2 * h) x[k] = fe_mul(x[k], x[k + h]);
            }
            Fe v = x[0];
            if (stop == 0) {  // the P is among lane 0's tiles: no other lane takes part
                v = shfl_idx(v, 0);
            } else {
#pragma unroll
                for (int d = 16; d > 0; d >>= 1) v = fe_mul(v, shfl_xor(v, d));
            }
            exclusive = last == tile - 1 ? v : fe_mul(exclusive, v);
            if (prefixes) break;
        }
        if (lane == 0) {
            if (tile > 0) publish(flags + tile, inclusives + tile, fe_mul(exclusive, aggregate), epoch << 2 | kPrefix);
            tile_before = exclusive;
        }
    }
    __syncthreads();
    Fe before = fe_mul(tile_before, warp_before[warp]);
    if (lane > 0) before = fe_mul(before, e);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) mine[k] = fe_mul(before, run[k]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
        const int64_t i = start + k * kThreads + t;
        if (i < n) stark::fe_store(out, n, i, items[k * kThreads + t]);
    }
}

// ---------------------------------------------------------------------------
// K9: out[i] = start * base^i from the bit bases base^(2^b), b < bits, in
// shared memory.  The grid has T = 2^m threads (m = step_bits(n)); thread
// i0 < T takes the elements i0 + k*T, k < ceil(n / T): it multiplies start
// by the bit bases of the bits set among the m low bits of i0, then steps
// by base^T = bases[m], one product an element.  Neighbouring threads
// write neighbouring elements, so every store is coalesced.  Where m = the
// bits of n - 1, T >= n and each thread writes its one element.
// ---------------------------------------------------------------------------

constexpr int kStepMinBits = 15;  // at least 2^15 threads where n allows (about a block an SM)
constexpr int kStepLogItems = 4;  // else 2^4 elements a thread

int bit_length(int64_t v) { return v > 0 ? 64 - __builtin_clzll(static_cast<unsigned long long>(v)) : 0; }

int step_bits(int64_t n) {
    const int bits = bit_length(n - 1);
    const int m = bits - kStepLogItems > kStepMinBits ? bits - kStepLogItems : kStepMinBits;
    return m < bits ? m : bits;
}

__global__ void geometric_kernel(const int32_t* __restrict__ start, const int32_t* __restrict__ bases, int bits,
                                 int m, int32_t* __restrict__ out, int64_t n) {
    __shared__ Fe base[kMaxBits];
    for (int b = threadIdx.x; b < bits; b += blockDim.x) base[b] = stark::fe_load(bases, bits, b);
    __syncthreads();
    const int64_t i0 = global_index();
    const int64_t stride = int64_t{1} << m;
    if (i0 >= n || i0 >= stride) return;
    Fe acc = stark::fe_load(start, 1, 0);
#pragma unroll 1
    for (int b = 0; b < m; ++b) {
        const bool bit = (i0 >> b) & 1;
        if (bit || b < 5) {  // from bit 5 up a warp's 32 threads share the bit: skipped where it is 0
            const Fe p = fe_mul(acc, base[b]);
            acc = bit ? p : acc;
        }
    }
    stark::fe_store(out, n, i0, acc);
    if (m >= bits) return;  // T >= n: one element a thread
    const Fe step = base[m];
#pragma unroll 1
    for (int64_t i = i0 + stride; i < n; i += stride) {
        acc = fe_mul(acc, step);
        stark::fe_store(out, n, i, acc);
    }
}

// ---------------------------------------------------------------------------
// K10: out = a op b; an operand with `*_col` set is one (8, 1) column.
// ---------------------------------------------------------------------------

template <int kOp>
__global__ void binary_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                              int32_t* __restrict__ out, int64_t n, bool a_col, bool b_col) {
    const int64_t i = global_index();
    if (i >= n) return;
    const Fe x = a_col ? stark::fe_load(a, 1, 0) : stark::fe_load(a, n, i);
    const Fe y = b_col ? stark::fe_load(b, 1, 0) : stark::fe_load(b, n, i);
    const Fe r = kOp == kMul ? fe_mul(x, y) : kOp == kAdd ? stark::fe_add(x, y) : stark::fe_sub(x, y);
    stark::fe_store(out, n, i, r);
}

// K10's row-by-column form: out[i * cols + j] = a[i] * b[j], a (8, rows)
// and b (8, cols); one element a thread, stores coalesced, the two small
// tables read through the cache.
__global__ void outer_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                             int32_t* __restrict__ out, int64_t rows, int64_t cols) {
    const int64_t k = global_index();
    const int64_t n = rows * cols;
    if (k >= n) return;
    const int64_t i = k / cols;
    stark::fe_store(out, n, k, fe_mul(stark::fe_load(a, rows, i), stark::fe_load(b, cols, k - i * cols)));
}

unsigned grid(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// a, out: (8, n).
extern "C" int stark_mont_inv(const int32_t* a, int32_t* out, int64_t n, void* stream) {
    if (n <= 0) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((n + kInvChunk - 1) / kInvChunk);
    inv_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, out, n);
    return cudaGetLastError();
}

// a, out: (8, n) (out may be a).  The status buffer of `capacity` tiles:
// ticket (one counter), flags (capacity words), aggregates and inclusives
// (capacity elements each, 16-byte aligned), zeroed when allocated; epoch
// in [1, 2^30), new each call; base: the ticket's count before this call.
extern "C" int stark_prefix_mul(const int32_t* a, int32_t* out, int64_t n, void* ticket, void* flags,
                                void* aggregates, void* inclusives, int64_t capacity, uint32_t epoch,
                                unsigned long long base, void* stream) {
    const int64_t tiles = (n + kScanChunk - 1) / kScanChunk;
    if (n <= 0 || tiles > capacity || epoch == 0 || epoch >= (1u << 30)) return cudaErrorInvalidValue;
    scan_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        a, out, n, static_cast<unsigned long long*>(ticket), static_cast<uint32_t*>(flags),
        static_cast<Fe*>(aggregates), static_cast<Fe*>(inclusives), epoch, base);
    return cudaGetLastError();
}

// start: (8, 1); bases: (8, bits), bits <= 64 and 2^bits >= n; out: (8, n).
extern "C" int stark_geometric_table(const int32_t* start, const int32_t* bases, int bits, int32_t* out, int64_t n,
                                     void* stream) {
    if (n <= 0 || bits < 0 || bits > kMaxBits || (bits < 63 && (int64_t{1} << bits) < n)) return cudaErrorInvalidValue;
    const int m = step_bits(n);
    const int64_t threads = (int64_t{1} << m) < n ? int64_t{1} << m : n;
    geometric_kernel<<<grid(threads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(start, bases, bits, m, out, n);
    return cudaGetLastError();
}

// The m of stark_geometric_table at n: its grid has min(2^m, n) threads,
// each writing the elements i0 + k * 2^m below n.
extern "C" int stark_geometric_step_bits(int64_t n) { return n > 0 ? step_bits(n) : -1; }

// a, b: (8, n), or (8, 1) where a_col / b_col is set; out: (8, n);
// op: 0 product, 1 sum, 2 difference.
extern "C" int stark_mont_binary(const int32_t* a, const int32_t* b, int32_t* out, int64_t n, int op, int a_col,
                                 int b_col, void* stream) {
    if (n <= 0) return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (op) {
        case kMul: binary_kernel<kMul><<<grid(n), kThreads, 0, s>>>(a, b, out, n, a_col != 0, b_col != 0); break;
        case kAdd: binary_kernel<kAdd><<<grid(n), kThreads, 0, s>>>(a, b, out, n, a_col != 0, b_col != 0); break;
        case kSub: binary_kernel<kSub><<<grid(n), kThreads, 0, s>>>(a, b, out, n, a_col != 0, b_col != 0); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// a: (8, rows); b: (8, cols); out: (8, rows * cols).
extern "C" int stark_mont_outer(const int32_t* a, const int32_t* b, int32_t* out, int64_t rows, int64_t cols,
                                void* stream) {
    if (rows <= 0 || cols <= 0) return cudaErrorInvalidValue;
    outer_kernel<<<grid(rows * cols), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, rows, cols);
    return cudaGetLastError();
}
