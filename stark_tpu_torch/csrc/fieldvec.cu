// GF(p) vector kernels for Hopper: inversion, prefix product, power table
// and one elementwise Montgomery operation (K7-K10).
//
// In the JAX package these are XLA-fused device functions with no Pallas
// form, used by device trace interpolation and the boundary quotients of
// Stark._prove_device (stark_tpu/ops/geometric_device.py, stark.py):
//
//   K7  stark_mont_inv         a^(p-2), 0 -> 0: field_ops.mont_inv
//                              (stark_tpu/ops/field_ops.py:432, :333)
//   K8  stark_prefix_mul       inclusive prefix product along the columns:
//                              geometric_device.prefix_mont_mul (:48)
//   K9  stark_geometric_table  start * base^i, i < n, from the bit bases
//                              base^(2^b): device_prover.geometric_table
//                              (stark_tpu/ops/device_prover.py:226)
//   K10 stark_mont_binary      a * b, a + b or a - b elementwise, either
//                              operand an (8, 1) column broadcast along n:
//                              field_ops.mont_mul / add / sub
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
// 3.35 TB/s.  The kernels here run more products than that: K7 162 an
// element (131 squarings, 31 multiplies), K9 one a bit of n, K8 2-3; so K7
// and K9 run far above their bounds.  Each design is the simple one: one
// element a thread (K7, K9, K10), a block-local scan with a second launch
// for the block totals (K8).

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using stark::Fe;
using stark::fe_mul;

constexpr int kThreads = 256;
constexpr int kScanItems = 8;                      // consecutive elements a thread scans
constexpr int kScanChunk = kThreads * kScanItems;  // elements a scan block covers
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

// ---------------------------------------------------------------------------
// K7: a^(p-2) with p - 2 = 406 * 2^119 + (2^119 - 1).  a^406 by its bits,
// then 23 windows of five ones and one of four: acc <- acc^32 * a^31, and
// acc^16 * a^15 last.  131 squarings and 31 multiplies, in registers.
// ---------------------------------------------------------------------------

__global__ void inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out, int64_t n) {
    const int64_t i = global_index();
    if (i >= n) return;
    const Fe x = stark::fe_load(a, n, i);
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
    acc = fe_mul(square_times<4>(acc), x15);
    stark::fe_store(out, n, i, acc);
}

// ---------------------------------------------------------------------------
// K8: inclusive prefix product.  A block covers kScanChunk elements, read
// coalesced into shared memory; each thread multiplies out its run of
// kScanItems consecutive elements, the block scans the runs' totals
// (Hillis-Steele over kThreads values in shared memory), and each thread
// multiplies its run by the product of the runs before it.  The block's
// total goes to `totals`; the host side scans the totals the same way and
// multiplies each later block by the product of the blocks before it.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads) scan_block_kernel(const int32_t* in, int32_t* out, int64_t n,
                                                              int32_t* totals, int64_t blocks) {
    __shared__ Fe items[kScanChunk];
    __shared__ Fe sums[2][kThreads];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanChunk;
    const int t = threadIdx.x;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
        const int64_t i = base + k * kThreads + t;
        items[k * kThreads + t] = i < n ? stark::fe_load(in, n, i) : mont_one();
    }
    __syncthreads();
    Fe run[kScanItems];
    run[0] = items[t * kScanItems];
#pragma unroll
    for (int k = 1; k < kScanItems; ++k) run[k] = fe_mul(run[k - 1], items[t * kScanItems + k]);
    int cur = 0;
    sums[0][t] = run[kScanItems - 1];
    __syncthreads();
#pragma unroll 1
    for (int d = 1; d < kThreads; d <<= 1) {  // log2(kThreads) rounds
        Fe v = sums[cur][t];
        if (t >= d) v = fe_mul(sums[cur][t - d], v);
        sums[cur ^ 1][t] = v;
        cur ^= 1;
        __syncthreads();
    }
    if (t > 0) {
        const Fe before = sums[cur][t - 1];
#pragma unroll
        for (int k = 0; k < kScanItems; ++k) run[k] = fe_mul(before, run[k]);
    }
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) items[t * kScanItems + k] = run[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
        const int64_t i = base + k * kThreads + t;
        if (i < n) stark::fe_store(out, n, i, items[k * kThreads + t]);
    }
    if (totals != nullptr && t == kThreads - 1) stark::fe_store(totals, blocks, blockIdx.x, sums[cur][kThreads - 1]);
}

// out[i] *= (scanned) totals[block of i - 1], for every i past the first block.
__global__ void scan_offsets_kernel(int32_t* __restrict__ out, int64_t n, const int32_t* __restrict__ totals,
                                    int64_t blocks) {
    const int64_t i = kScanChunk + global_index();
    if (i >= n) return;
    const Fe before = stark::fe_load(totals, blocks, i / kScanChunk - 1);
    stark::fe_store(out, n, i, fe_mul(before, stark::fe_load(out, n, i)));
}

// The scan of n elements: one block launch, and where it took more than one
// block, the scan of its block totals (in place, in `scratch`, whose next
// levels follow) and the offsets launch.
cudaError_t scan(const int32_t* in, int32_t* out, int64_t n, int32_t* scratch, cudaStream_t stream) {
    const int64_t blocks = (n + kScanChunk - 1) / kScanChunk;
    scan_block_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(in, out, n,
                                                                             blocks > 1 ? scratch : nullptr, blocks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || blocks == 1) return err;
    err = scan(scratch, scratch, blocks, scratch + 8 * blocks, stream);
    if (err != cudaSuccess) return err;
    const int64_t rest = n - kScanChunk;
    scan_offsets_kernel<<<static_cast<unsigned>((rest + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        out, n, scratch, blocks);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K9: out[i] = start * prod_{bit b of i set} bases[b].  The bases sit in
// shared memory (one thread loads each: bits <= kMaxBits < kThreads); a
// thread multiplies by the base or by one at every bit, so the loop, one
// product an iteration, has no branch.
// ---------------------------------------------------------------------------

__global__ void geometric_kernel(const int32_t* __restrict__ start, const int32_t* __restrict__ bases, int bits,
                                 int32_t* __restrict__ out, int64_t n) {
    static_assert(kMaxBits <= kThreads, "one thread loads each bit base");
    __shared__ Fe base[kMaxBits];
    if (static_cast<int>(threadIdx.x) < bits) base[threadIdx.x] = stark::fe_load(bases, bits, threadIdx.x);
    __syncthreads();
    const int64_t i = global_index();
    if (i >= n) return;
    Fe acc = stark::fe_load(start, 1, 0);
    const Fe one = mont_one();
#pragma unroll 1
    for (int b = 0; b < bits; ++b) acc = fe_mul(acc, ((i >> b) & 1) ? base[b] : one);
    stark::fe_store(out, n, i, acc);
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

unsigned grid(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace

// a, out: (8, n).
extern "C" int stark_mont_inv(const int32_t* a, int32_t* out, int64_t n, void* stream) {
    if (n <= 0) return cudaErrorInvalidValue;
    inv_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, out, n);
    return cudaGetLastError();
}

// a, out: (8, n) (out may be a); scratch: 8 * stark_prefix_scratch(n) words.
extern "C" int stark_prefix_mul(const int32_t* a, int32_t* out, int64_t n, int32_t* scratch, void* stream) {
    if (n <= 0 || (n > kScanChunk && scratch == nullptr)) return cudaErrorInvalidValue;
    return scan(a, out, n, scratch, static_cast<cudaStream_t>(stream));
}

// Kernels one stark_prefix_mul call at n launches: the block scan, and past
// one block the scan of the block totals and the offsets launch.
extern "C" int stark_prefix_launches(int64_t n) {
    return n <= kScanChunk ? 1 : stark_prefix_launches((n + kScanChunk - 1) / kScanChunk) + 2;
}

// Columns of block totals the scan of n elements keeps in its scratch.
extern "C" int64_t stark_prefix_scratch(int64_t n) {
    int64_t total = 0;
    while (n > kScanChunk) {
        n = (n + kScanChunk - 1) / kScanChunk;
        total += n;
    }
    return total;
}

// start: (8, 1); bases: (8, bits), bits <= 64 and 2^bits >= n; out: (8, n).
extern "C" int stark_geometric_table(const int32_t* start, const int32_t* bases, int bits, int32_t* out, int64_t n,
                                     void* stream) {
    if (n <= 0 || bits < 0 || bits > kMaxBits || (bits < 63 && (int64_t{1} << bits) < n)) return cudaErrorInvalidValue;
    geometric_kernel<<<grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(start, bases, bits, out, n);
    return cudaGetLastError();
}

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
