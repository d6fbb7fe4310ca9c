// Blake2b-256 Merkle kernels (K4 leaves, K5 levels) for Hopper.
//
// Replaces the Pallas kernels of stark_tpu/ops/pallas_merkle.py
// (leaf_digests_pallas / _leaf_kernel and level_hash_pallas /
// _level_kernel).  The TPU has no 64-bit integer path, so the JAX code
// holds every u64 word as a (lo, hi) pair of u32 lanes; here the words are
// native uint64_t with funnel-shift rotates.
//
// Design: one thread per hash; the 16-word state and the 16 message words
// stay in registers, and the SIGMA schedule is unrolled at compile time (the
// ROUND macro below), so message "gathers" are register renames.  A
// single-block compress is ~1.1k 64-bit integer ops against 32 to 64
// bytes of loads and 32 bytes of stores, so the kernels are bound by
// integer throughput, not by memory.
//
// Layouts are the JAX package's: digits (4, n) and digest words (8, w),
// u32 bits held in int32 tensors.  The level kernel reads its children
// (2i, 2i + 1) itself; the even/odd split of the TPU version was a Mosaic
// restriction, as was its 256-wide minimum level.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

constexpr uint64_t kIV0 = 0x6A09E667F3BCC908ull, kIV1 = 0xBB67AE8584CAA73Bull;
constexpr uint64_t kIV2 = 0x3C6EF372FE94F82Bull, kIV3 = 0xA54FF53A5F1D36F1ull;
constexpr uint64_t kIV4 = 0x510E527FADE682D1ull, kIV5 = 0x9B05688C2B3E6C1Full;
constexpr uint64_t kIV6 = 0x1F83D9ABFB41BD6Bull, kIV7 = 0x5BE0CD19137E2179ull;
// unkeyed 32-byte digest: h[0] = IV[0] ^ 0x01010020 (digest_length=32, fanout=1, depth=1)
constexpr uint64_t kH0 = kIV0 ^ 0x01010020ull;

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

__device__ __forceinline__ void g(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, uint64_t x, uint64_t y) {
    a = a + b + x; d = rotr64(d ^ a, 32); c = c + d; b = rotr64(b ^ c, 24);
    a = a + b + y; d = rotr64(d ^ a, 16); c = c + d; b = rotr64(b ^ c, 63);
}

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
    g(v0, v4, v8, v12, m[s0], m[s1]);                                                  \
    g(v1, v5, v9, v13, m[s2], m[s3]);                                                  \
    g(v2, v6, v10, v14, m[s4], m[s5]);                                                 \
    g(v3, v7, v11, v15, m[s6], m[s7]);                                                 \
    g(v0, v5, v10, v15, m[s8], m[s9]);                                                 \
    g(v1, v6, v11, v12, m[s10], m[s11]);                                               \
    g(v2, v7, v8, v13, m[s12], m[s13]);                                                \
    g(v3, v4, v9, v14, m[s14], m[s15]);

// One final-block Blake2b-256 compression of the 16 message words m with
// byte counter t; writes the digest's four u64 words.
__device__ __forceinline__ void blake2b256_block(const uint64_t (&m)[16], uint64_t t, uint64_t (&h)[4]) {
    uint64_t v0 = kH0, v1 = kIV1, v2 = kIV2, v3 = kIV3, v4 = kIV4, v5 = kIV5, v6 = kIV6, v7 = kIV7;
    uint64_t v8 = kIV0, v9 = kIV1, v10 = kIV2, v11 = kIV3;
    uint64_t v12 = kIV4 ^ t, v13 = kIV5, v14 = ~kIV6, v15 = kIV7;
    ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
    ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
    ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
    ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
    ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
    ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
    ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
    ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
    ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
    ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
    h[0] = kH0 ^ v0 ^ v8;
    h[1] = kIV1 ^ v1 ^ v9;
    h[2] = kIV2 ^ v2 ^ v10;
    h[3] = kIV3 ^ v3 ^ v11;
}

#undef ROUND

__device__ __forceinline__ void store_digest(uint32_t* __restrict__ out, int64_t plane, int64_t i,
                                             const uint64_t (&h)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        out[(2 * j) * plane + i] = static_cast<uint32_t>(h[j]);
        out[(2 * j + 1) * plane + i] = static_cast<uint32_t>(h[j] >> 32);
    }
}

// Leaf i: Blake2b-256 of bincode(FieldElement) = sign u32 | digit count
// u64 | k base-2^32 digits, where k = index + 1 of the highest nonzero
// digit (0 for zero) and sign = 2 (Plus) if k > 0 else 1 (NoSign).
__global__ void leaf_kernel(const uint32_t* __restrict__ digits, uint32_t* __restrict__ out, int64_t n) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t d0 = digits[i], d1 = digits[n + i], d2 = digits[2 * n + i], d3 = digits[3 * n + i];
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

// Parent i = Blake2b-256(child 2i || child 2i + 1), one 64-byte block.
__global__ void level_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t w) {
    const int64_t half = w / 2;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= half) return;
    uint64_t m[16] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        m[j] = in[(2 * j) * w + 2 * i] | (static_cast<uint64_t>(in[(2 * j + 1) * w + 2 * i]) << 32);
        m[4 + j] = in[(2 * j) * w + 2 * i + 1] | (static_cast<uint64_t>(in[(2 * j + 1) * w + 2 * i + 1]) << 32);
    }
    uint64_t h[4];
    blake2b256_block(m, 64, h);
    store_digest(out, half, i, h);
}

}  // namespace

// digits: (4, n); out: (8, n).
extern "C" int stark_merkle_leaves(const int32_t* digits, int32_t* out, int64_t n, void* stream) {
    if (n <= 0) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    leaf_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(digits), reinterpret_cast<uint32_t*>(out), n);
    return cudaGetLastError();
}

// level: (8, w) with w even; out: (8, w / 2).
extern "C" int stark_merkle_level(const int32_t* level, int32_t* out, int64_t w, void* stream) {
    if (w < 2 || w % 2) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((w / 2 + kThreads - 1) / kThreads);
    level_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(level), reinterpret_cast<uint32_t*>(out), w);
    return cudaGetLastError();
}
