// Blake2b-256 Merkle kernels (K4 leaves, K5 levels) for Hopper.
//
// Replaces the Pallas kernels of stark_tpu/ops/pallas_merkle.py
// (leaf_digests_pallas / _leaf_kernel and level_hash_pallas /
// _level_kernel).  The TPU has no 64-bit integer path, so the JAX code
// holds every u64 word as a (lo, hi) pair of u32 lanes; here the words are
// native uint64_t with funnel-shift rotates.
//
// Design: one thread per hash; the 16-word state and the 16 message words
// stay in registers, and the SIGMA schedule is unrolled at compile time
// (blake2b.cuh), so message "gathers" are register renames.  A
// single-block compress is ~1.1k 64-bit integer ops against 32 to 64
// bytes of loads and 32 bytes of stores, so the wide levels are bound by
// integer throughput, not by memory.
//
// The narrow levels at the top of a tree are not: a level of a few hundred
// parents or fewer fills a fraction of one SM, and its time is a launch gap,
// a global round trip and one compress's latency.  So the top kernel (the
// narrow levels of the JAX package's tree_levels, which hashes them outside
// its Pallas kernel) hashes every level of a narrow subtree down to the
// root in one launch: one block, each level built from the previous one in
// shared memory, a barrier between levels.
//
// The middle levels, from a few hundred thousand parents down to 512, are
// neither: a level of a few thousand parents is a few microseconds of ALU
// work, less than its launch and round trip.  The subtrees kernel replaces
// the chain of level_hash_pallas calls in tree_levels
// (stark_tpu/ops/pallas_merkle.py:215-240) for those levels: one launch
// hashes `depth` levels, a block taking one or more whole subtrees of
// 2^depth children, level 1 from global memory and each later level from
// the previous one in shared memory, every level also stored to its slab
// of one flat output.  Its bound is the ALU work of its compressions (K5's
// SASS a compress); what it saves is depth - 1 launches and global round
// trips, and what it pays is a block's chain of depth compressions, one
// compress's latency a level.  No more blocks than SMs: each SM then
// hashes its share of every level in one block.  The top kernel is the
// one-block, one-subtree case of the same level loop (hash_levels) as far
// as its levels are wide.
//
// A narrow level is bound by one compress's latency, not by the SM's ALU
// work: a level of 64 parents or fewer fills at most two of the SM's warps
// with one thread a parent, and a scheduler feeds one warp's ALU
// instructions one every 2 clocks, ~3,700 clocks a compress however few of
// its lanes hash.  So the top kernel hashes each such level with a compress
// split over four lanes (hash_top_levels, quad_compress), as the SIMD
// Blake2b implementations split it over a vector's four columns: the
// 16-word state is four rows a, b, c, d; lane i of a quad holds column i
// of each row and runs one G function a half-round; before the diagonal
// half-round rows b, c and d rotate by 1, 2 and 3 lanes (warp shuffles
// inside the quad, two a word) and after it they rotate back.  A lane
// issues about a quarter of a compress, and the compress takes its
// dependent chain of 24 G functions and 24 shuffle steps.  The parent's
// message block goes to shared memory, one row a quad, and each lane reads
// its four words a round at the SIGMA offsets of its column, a constant a
// round selected by the lane (quad_sigma), so no lane indexes a register
// array.  Levels of more than 64 parents keep one thread a parent: there
// the SM's ALU work is the bound, and the shuffles would add to it.  The
// subtrees kernel keeps hash_levels.
//
// Layouts are the JAX package's: digits (4, n) and digest words (8, w),
// u32 bits held in int32 tensors.
//
// The leaf kernel also takes the prover's codewords as they are, (8, n)
// Montgomery limbs: the JAX package converts them to digits first
// (stark_tpu/ops/device_prover.py _plain_digits, an XLA function); here
// each thread loads its element's 32 bytes, reduces it out of Montgomery
// form in registers (field.cuh fe_from_mont, one REDC: ~40 integer
// instructions beside the compress's ~1.1k) and hashes as before, so no
// digit array is written and read again.  The same conversion alone
// (mont_digits_kernel) serves the opening gathers and the host fetches of
// small codewords (_plain_digits there), and its gather form
// (mont_digits_gather_kernel) the opening gathers (_value_gather there):
// it reads the columns of up to kGatherMaxCodewords codewords itself, at
// indices passed by value, so a gather is one launch, bound by the launch
// (a few hundred elements of 48 bytes).  The level kernel reads its children
// (2i, 2i + 1) itself; the even/odd split of the TPU version was a Mosaic
// restriction, as was its 256-wide minimum level.

#include <cuda_runtime.h>

#include <cstdint>

#include "blake2b.cuh"
#include "field.cuh"

namespace {

using stark::blake2b256_block;
using stark::store_digest;

constexpr int kThreads = 256;
// threads of the top kernel at most: its widest level's parents take turns
// beyond them, and the bound leaves each thread up to 128 registers, so the
// level loop keeps its state out of local memory
constexpr int kTopThreads = 512;
// widest level the top kernel takes: its two shared buffers (w/2 and w/4
// digests of 32 bytes) then fill 192 KB of the SM's 227 KB
constexpr int64_t kTopMaxWidth = 8192;

// shared memory of a block hashing the levels above w children: its two
// buffers of w/2 and w/4 digests of 32 bytes
constexpr size_t top_smem_bytes(int64_t w) { return static_cast<size_t>(24 * w); }
// the subtrees kernel: threads a block at most, and the fewest children a
// block takes (kSubChunk / 2 threads hash one parent each at level 1)
constexpr int kSubThreads = 256;
constexpr int64_t kSubChunk = 256;
// the top kernel hashes a level of at most this many parents four lanes a
// parent, a wider one a thread a parent
constexpr int64_t kQuadMaxParents = 64;
// the gather form of the digit conversion: codewords and indices a launch
constexpr int kGatherMaxCodewords = 64;
constexpr int kGatherMaxIndices = 256;
constexpr int kGatherThreads = 128;

// threads of the top kernel at width w: a thread a parent of its widest
// level (at most kTopThreads) and four lanes a parent of its narrow levels,
// at least one warp
constexpr int top_threads(int64_t w) {
    int64_t threads = 32;
    for (int64_t half = w / 2; half >= 1; half /= 2) {
        const int64_t lanes = half > kQuadMaxParents ? (half > kTopThreads ? kTopThreads : half) : 4 * half;
        if (lanes > threads) threads = lanes;
    }
    return static_cast<int>(threads);
}

// Element i of an (8, n) Montgomery limb array as its plain base-2^32 digits.
__device__ __forceinline__ stark::Fe plain_digits_of(const int32_t* __restrict__ mont, int64_t n, int64_t i) {
    return stark::fe_from_mont(stark::fe_load(mont, n, i));
}

// Leaf i: Blake2b-256 of bincode(FieldElement) = sign u32 | digit count
// u64 | k base-2^32 digits, where k = index + 1 of the highest nonzero
// digit (0 for zero) and sign = 2 (Plus) if k > 0 else 1 (NoSign).  kMont:
// the input is (8, n) Montgomery limbs, else (4, n) plain digits.
template <bool kMont>
__global__ void leaf_kernel(const int32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t n) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t d0, d1, d2, d3;
    if constexpr (kMont) {
        const stark::Fe v = plain_digits_of(in, n, i);
        d0 = v.w[0]; d1 = v.w[1]; d2 = v.w[2]; d3 = v.w[3];
    } else {
        const uint32_t* digits = reinterpret_cast<const uint32_t*>(in);
        d0 = digits[i]; d1 = digits[n + i]; d2 = digits[2 * n + i]; d3 = digits[3 * n + i];
    }
    const uint64_t k = d3 ? 4 : d2 ? 3 : d1 ? 2 : d0 ? 1 : 0;
    uint64_t m[16] = {};
    m[0] = (k ? 2ull : 1ull) | (k << 32);
    m[1] = static_cast<uint64_t>(d0) << 32;
    m[2] = d1 | (static_cast<uint64_t>(d2) << 32);
    m[3] = d3;
    uint64_t h[4];
    blake2b256_block(m, 12 + 4 * k, h);
    store_digest(out, n, i, h);
}

// digits[k * n + i] = word k of element i's plain value, from (8, n)
// Montgomery limbs.
__global__ void mont_digits_kernel(const int32_t* __restrict__ mont, uint32_t* __restrict__ digits, int64_t n) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const stark::Fe v = plain_digits_of(mont, n, i);
#pragma unroll
    for (int k = 0; k < 4; ++k) digits[k * n + i] = v.w[k];
}

// One gather of the opening values: column g * group_stride + r (from
// `first`) of the (4, stride) digits is element indices[r] of codeword g.
// Passed by value (__grid_constant__): the pointers and indices are read
// from the parameter bank, and nothing is uploaded for a gather.
struct GatherParams {
    const int32_t* codewords[kGatherMaxCodewords];  // (8, n) Montgomery limbs each
    uint32_t indices[kGatherMaxIndices];             // each < n
    int32_t* digits;
    int64_t n;
    int64_t stride;        // columns of the digits' rows
    int64_t group_stride;  // columns between two codewords' values
    int64_t first;         // column of codeword 0's value at indices[0]
    int32_t n_codewords;
    int32_t n_indices;
};

__global__ void __launch_bounds__(kGatherThreads) mont_digits_gather_kernel(const __grid_constant__ GatherParams p) {
    const int t = static_cast<int>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= p.n_codewords * p.n_indices) return;
    const int g = t / p.n_indices;
    const int r = t - g * p.n_indices;
    const stark::Fe v = plain_digits_of(p.codewords[g], p.n, p.indices[r]);
    const int64_t col = p.first + g * p.group_stride + r;
    uint32_t* const digits = reinterpret_cast<uint32_t*>(p.digits);
#pragma unroll
    for (int k = 0; k < 4; ++k) digits[k * p.stride + col] = v.w[k];
}

// Parent i of the planar (8, w) level src (global or shared memory):
// Blake2b-256(child 2i || child 2i + 1), each row's two words in one load.
__device__ __forceinline__ void hash_parent(const uint32_t* src, int64_t w, int64_t i, uint64_t (&h)[4]) {
    uint64_t m[16] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const uint2 lo = reinterpret_cast<const uint2*>(src + (2 * j) * w)[i];  // words 2i, 2i + 1 of row 2j
        const uint2 hi = reinterpret_cast<const uint2*>(src + (2 * j + 1) * w)[i];
        m[j] = lo.x | (static_cast<uint64_t>(hi.x) << 32);
        m[4 + j] = lo.y | (static_cast<uint64_t>(hi.y) << 32);
    }
    blake2b256_block(m, 64, h);
}

// Levels 1 .. depth above the block's `chunk` children, which start at
// column `first` of the (8, w) level `in` (global memory): level k (chunk /
// 2^k parents) goes to columns first / 2^k .. of its (8, w / 2^k) slab of
// `out`, the slabs of levels 1, 2, ... laid end to end, and to one of two
// shared buffers (even: chunk / 2 digests, odd: chunk / 4), from which the
// next level reads it after a barrier.  A thread hashes parents t,
// t + blockDim.x, ...; every thread of the block must call this.
__device__ __forceinline__ void hash_levels(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t w,
                                            int64_t first, int64_t chunk, int depth, uint32_t* even, uint32_t* odd) {
    const uint32_t* src = in + first;
    int64_t plane = w;  // row stride of src
    uint32_t* dst = even;
#pragma unroll 1
    for (int k = 1; k <= depth; ++k) {
        const int64_t half = chunk >> k;
        const int64_t slab_w = w >> k;
        uint32_t* const slab = out + (first >> k);
#pragma unroll 1
        for (int64_t i = threadIdx.x; i < half; i += blockDim.x) {
            uint64_t h[4];
            hash_parent(src, plane, i, h);
            store_digest(dst, half, i, h);
            store_digest(slab, slab_w, i, h);
        }
        __syncthreads();
        out += 8 * slab_w;
        src = dst;
        plane = half;
        dst = dst == even ? odd : even;
    }
}

// The message words lane `lane` of a quad reads in round r: its column G's
// (SIGMA[r][2 lane], SIGMA[r][2 lane + 1]) and its diagonal G's
// (SIGMA[r][8 + 2 lane], SIGMA[r][9 + 2 lane]), four bits each.  Rounds 10
// and 11 repeat rounds 0 and 1.
__host__ __device__ constexpr uint32_t quad_sigma(int lane, int r) {
    const uint8_t sigma[10][16] = {
        {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15}, {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
        {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4}, {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
        {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13}, {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
        {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11}, {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
        {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5}, {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};
    const uint8_t* row = sigma[r % 10];
    return row[2 * lane] | row[2 * lane + 1] << 4 | row[8 + 2 * lane] << 8 | row[9 + 2 * lane] << 12;
}

// x of the lane `by` places on in the quad; every lane of the warp calls it
__device__ __forceinline__ uint64_t quad_rotate(uint64_t x, int lane, int by) {
    return __shfl_sync(0xFFFFFFFFu, static_cast<unsigned long long>(x), (lane + by) & 3, 4);
}

// Rounds kRound .. 11 of quad_compress, each round's message offsets a
// compile-time constant chosen by the lane (a select, no memory), made just
// before the round reads them.
template <int kRound>
__device__ __forceinline__ void quad_rounds(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, const uint64_t* m,
                                            int lane) {
    if constexpr (kRound < 12) {
        constexpr uint32_t s0 = quad_sigma(0, kRound), s1 = quad_sigma(1, kRound);
        constexpr uint32_t s2 = quad_sigma(2, kRound), s3 = quad_sigma(3, kRound);
        const uint32_t s = lane == 0 ? s0 : lane == 1 ? s1 : lane == 2 ? s2 : s3;
        stark::blake2b_g(a, b, c, d, m[s & 15], m[(s >> 4) & 15]);
        b = quad_rotate(b, lane, 1);
        c = quad_rotate(c, lane, 2);
        d = quad_rotate(d, lane, 3);
        stark::blake2b_g(a, b, c, d, m[(s >> 8) & 15], m[s >> 12]);
        b = quad_rotate(b, lane, 3);
        c = quad_rotate(c, lane, 2);
        d = quad_rotate(d, lane, 1);
        quad_rounds<kRound + 1>(a, b, c, d, m, lane);
    }
}

// One final-block Blake2b-256 compress (byte counter 64) of the 16 message
// words m (shared memory), split over a quad: lane `lane` holds column lane
// of the state's rows a, b, c, d and returns digest word `lane`.  Every lane
// of the warp calls it.
__device__ __forceinline__ uint64_t quad_compress(const uint64_t* m, int lane) {
    using namespace stark;
    const uint64_t h = lane == 0 ? kH0 : lane == 1 ? kIV1 : lane == 2 ? kIV2 : kIV3;
    uint64_t a = h;
    uint64_t b = lane == 0 ? kIV4 : lane == 1 ? kIV5 : lane == 2 ? kIV6 : kIV7;
    uint64_t c = lane == 0 ? kIV0 : lane == 1 ? kIV1 : lane == 2 ? kIV2 : kIV3;
    uint64_t d = lane == 0 ? kIV4 ^ 64 : lane == 1 ? kIV5 : lane == 2 ? ~kIV6 : kIV7;
    quad_rounds<0>(a, b, c, d, m, lane);
    return h ^ a ^ c;
}

// The top kernel's level loop: the levels above the (8, w) level `in`
// (global memory) down to the root, each to its (8, w / 2^k) slab of `out`
// and to one of two shared buffers (even, odd), from which the next level
// reads it.  A level of more than kQuadMaxParents parents hashes a parent a
// thread (as hash_levels), a narrower one a parent a quad of lanes, its
// message staged in row `parent` of `msg` (words 8 .. 15 zero).  Every lane
// of a warp that holds a parent runs the compress, so the shuffles name the
// whole warp; a quad past the level's last parent (levels of fewer than 8)
// hashes its stale row and stores nothing.  The warp's branch is a vote
// (__any_sync), which the compiler knows to be the same in every lane: with
// a branch on the thread index it wraps each shuffle in a convergence
// sequence (a WARPSYNC and an ENDCOLLECTIVE each).  Every thread of the
// block must call this.
__device__ __forceinline__ void hash_top_levels(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t w,
                                                uint32_t* even, uint32_t* odd, uint64_t (*msg)[17]) {
    const int lane = threadIdx.x & 3;
    const int64_t quad = threadIdx.x >> 2;
    if (quad < kQuadMaxParents) {
        msg[quad][8 + 2 * lane] = 0;
        msg[quad][9 + 2 * lane] = 0;
    }
    const uint32_t* src = in;
    int64_t plane = w;  // row stride of src
    uint32_t* dst = even;
#pragma unroll 1
    for (int64_t half = w / 2; half >= 1; half /= 2) {
        if (half > kQuadMaxParents) {
#pragma unroll 1
            for (int64_t i = threadIdx.x; i < half; i += blockDim.x) {
                uint64_t h[4];
                hash_parent(src, plane, i, h);
                store_digest(dst, half, i, h);
                store_digest(out, half, i, h);
            }
        } else if (__any_sync(0xFFFFFFFFu, quad < half)) {  // the warp holds a parent
            const bool mine = quad < half;
            if (mine) {
                // words 2 lane and 2 lane + 1 of row 2 lane's plane: the
                // lane's message words m[lane] (left child) and m[4 + lane]
                const uint2 lo = reinterpret_cast<const uint2*>(src + (2 * lane) * plane)[quad];
                const uint2 hi = reinterpret_cast<const uint2*>(src + (2 * lane + 1) * plane)[quad];
                msg[quad][lane] = lo.x | (static_cast<uint64_t>(hi.x) << 32);
                msg[quad][4 + lane] = lo.y | (static_cast<uint64_t>(hi.y) << 32);
            }
            __syncwarp();
            const uint64_t h = quad_compress(msg[quad], lane);
            if (mine) {
                const uint32_t h_lo = static_cast<uint32_t>(h), h_hi = static_cast<uint32_t>(h >> 32);
                dst[(2 * lane) * half + quad] = h_lo;
                dst[(2 * lane + 1) * half + quad] = h_hi;
                out[(2 * lane) * half + quad] = h_lo;
                out[(2 * lane + 1) * half + quad] = h_hi;
            }
        }
        __syncthreads();
        out += 8 * half;
        src = dst;
        plane = half;
        dst = dst == even ? odd : even;
    }
}

// Every level of the (8, w) subtree in one block, w a power of two, down
// to the root.
__global__ void __launch_bounds__(kTopThreads) top_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                                          int64_t w) {
    extern __shared__ uint2 top_shared[];  // uint2: the 8-byte alignment of the paired loads
    __shared__ uint64_t msg[kQuadMaxParents][17];  // a quad's message block; 17: quads apart by two banks
    uint32_t* const even = reinterpret_cast<uint32_t*>(top_shared);
    hash_top_levels(in, out, w, even, even + 8 * (w / 2), msg);
}

// `depth` levels above the (8, w) level, a block a chunk of `chunk`
// consecutive children (whole subtrees of 2^depth).
__global__ void __launch_bounds__(kSubThreads) subtrees_kernel(const uint32_t* __restrict__ in,
                                                               uint32_t* __restrict__ out, int64_t w, int64_t chunk,
                                                               int depth) {
    extern __shared__ uint2 sub_shared[];
    uint32_t* const even = reinterpret_cast<uint32_t*>(sub_shared);
    hash_levels(in, out, w, static_cast<int64_t>(blockIdx.x) * chunk, chunk, depth, even, even + 8 * (chunk / 2));
}

}  // namespace

// digits: (4, n); out: (8, n).
extern "C" int stark_merkle_leaves(const int32_t* digits, int32_t* out, int64_t n, void* stream) {
    if (n <= 0) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    leaf_kernel<false><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        digits, reinterpret_cast<uint32_t*>(out), n);
    return cudaGetLastError();
}

// mont: (8, n) Montgomery limbs; out: (8, n).
extern "C" int stark_merkle_leaves_mont(const int32_t* mont, int32_t* out, int64_t n, void* stream) {
    if (n <= 0) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    leaf_kernel<true><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        mont, reinterpret_cast<uint32_t*>(out), n);
    return cudaGetLastError();
}

// mont: (8, n) Montgomery limbs; digits: (4, n) plain base-2^32 digits.
extern "C" int stark_mont_digits(const int32_t* mont, int32_t* digits, int64_t n, void* stream) {
    if (n <= 0) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    mont_digits_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        mont, reinterpret_cast<uint32_t*>(digits), n);
    return cudaGetLastError();
}

// params: a GatherParams, filled by ops/cuda_merkle.py.
extern "C" int stark_mont_digits_gather(const void* params, void* stream) {
    const GatherParams& p = *static_cast<const GatherParams*>(params);
    if (p.n_codewords < 1 || p.n_codewords > kGatherMaxCodewords || p.n_indices < 1 ||
        p.n_indices > kGatherMaxIndices || p.n < 1)
        return cudaErrorInvalidValue;
    const int elements = p.n_codewords * p.n_indices;
    mont_digits_gather_kernel<<<(elements + kGatherThreads - 1) / kGatherThreads, kGatherThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
}

// sizeof(GatherParams), for the wrapper's check of its copy of the layout
extern "C" int stark_mont_digits_gather_params_size() { return static_cast<int>(sizeof(GatherParams)); }

// level: (8, w) with w even; out: (8, w / 2).
extern "C" int stark_merkle_level(const int32_t* level, int32_t* out, int64_t w, void* stream) {
    if (w < 2 || w % 2) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((w / 2 + kThreads - 1) / kThreads);
    stark::level_kernel<12><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(level), reinterpret_cast<uint32_t*>(out), w);
    return cudaGetLastError();
}

// level: (8, w) with w a power of two, 2 <= w <= 8192; out: 8 * (w - 1)
// words, the (8, w / 2^k) slabs of levels k = 1 .. log2 w, the root last.
extern "C" int stark_merkle_top(const int32_t* level, int32_t* out, int64_t w, void* stream) {
    if (w < 2 || w > kTopMaxWidth || (w & (w - 1))) return cudaErrorInvalidValue;
    // the limit is the current device's: opt in at every launch, as the NTT passes do
    const cudaError_t opt_in = cudaFuncSetAttribute(top_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(top_smem_bytes(kTopMaxWidth)));
    if (opt_in != cudaSuccess) return opt_in;
    top_kernel<<<1, top_threads(w), top_smem_bytes(w), static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(level), reinterpret_cast<uint32_t*>(out), w);
    return cudaGetLastError();
}

// level: (8, w) with w a power of two; 1 <= depth, 2^depth <= min(w, 8192);
// out: 8 * (w - w / 2^depth) words, the (8, w / 2^k) slabs of levels
// k = 1 .. depth.
extern "C" int stark_merkle_subtrees(const int32_t* level, int32_t* out, int64_t w, int depth, void* stream) {
    if (w < 2 || (w & (w - 1)) || depth < 1 || depth > 13 || (int64_t{1} << depth) > w ||
        (int64_t{1} << depth) > kTopMaxWidth)
        return cudaErrorInvalidValue;
    // a block a chunk of whole subtrees, at least kSubChunk children, and
    // no more blocks than SMs where the shared memory allows
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    int64_t chunk = int64_t{1} << depth;
    while (chunk < w && chunk < kTopMaxWidth && (chunk < kSubChunk || w / chunk > sms)) chunk *= 2;
    err = cudaFuncSetAttribute(subtrees_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(top_smem_bytes(kTopMaxWidth)));
    if (err != cudaSuccess) return err;
    const int threads = static_cast<int>(chunk / 2 < 32 ? 32 : chunk / 2 > kSubThreads ? kSubThreads : chunk / 2);
    subtrees_kernel<<<static_cast<unsigned>(w / chunk), threads, top_smem_bytes(chunk),
                      static_cast<cudaStream_t>(stream)>>>(reinterpret_cast<const uint32_t*>(level),
                                                           reinterpret_cast<uint32_t*>(out), w, chunk, depth);
    return cudaGetLastError();
}
