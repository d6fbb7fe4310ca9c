// Blake2b-256 of one final block and the level kernel, for the Merkle
// kernels (merkle.cu) and the Merkle roofline probe (probes.cu).
//
// The TPU code holds every u64 word as a (lo, hi) pair of u32 lanes; here
// the words are native uint64_t with funnel-shift rotates.  The 16-word
// state and the 16 message words stay in registers, and the SIGMA schedule
// is unrolled at compile time (the ROUND macro below), so message
// "gathers" are register renames.
//
// The round count is a template argument: 12 is Blake2b, the only valid
// hash; fewer rounds are for the roofline probe alone, as the JAX
// package's blake2b256_single_block(..., rounds=) is
// (stark_tpu/ops/device_merkle.py).  Each round is compiled in or out at
// compile time, so the 12-round body is the same code at any count.
#pragma once

#include <cstdint>

namespace stark {

constexpr uint64_t kIV0 = 0x6A09E667F3BCC908ull, kIV1 = 0xBB67AE8584CAA73Bull;
constexpr uint64_t kIV2 = 0x3C6EF372FE94F82Bull, kIV3 = 0xA54FF53A5F1D36F1ull;
constexpr uint64_t kIV4 = 0x510E527FADE682D1ull, kIV5 = 0x9B05688C2B3E6C1Full;
constexpr uint64_t kIV6 = 0x1F83D9ABFB41BD6Bull, kIV7 = 0x5BE0CD19137E2179ull;
// unkeyed 32-byte digest: h[0] = IV[0] ^ 0x01010020 (digest_length=32, fanout=1, depth=1)
constexpr uint64_t kH0 = kIV0 ^ 0x01010020ull;

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

__device__ __forceinline__ void blake2b_g(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d, uint64_t x,
                                          uint64_t y) {
    a = a + b + x; d = rotr64(d ^ a, 32); c = c + d; b = rotr64(b ^ c, 24);
    a = a + b + y; d = rotr64(d ^ a, 16); c = c + d; b = rotr64(b ^ c, 63);
}

// round r (0-based) of the compress, run only while r < kRounds
#define STARK_BLAKE2B_ROUND(r, s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
    if constexpr ((r) < kRounds) {                                                                   \
        blake2b_g(v0, v4, v8, v12, m[s0], m[s1]);                                                    \
        blake2b_g(v1, v5, v9, v13, m[s2], m[s3]);                                                    \
        blake2b_g(v2, v6, v10, v14, m[s4], m[s5]);                                                   \
        blake2b_g(v3, v7, v11, v15, m[s6], m[s7]);                                                   \
        blake2b_g(v0, v5, v10, v15, m[s8], m[s9]);                                                   \
        blake2b_g(v1, v6, v11, v12, m[s10], m[s11]);                                                 \
        blake2b_g(v2, v7, v8, v13, m[s12], m[s13]);                                                  \
        blake2b_g(v3, v4, v9, v14, m[s14], m[s15]);                                                  \
    }

// One final-block Blake2b-256 compression of the 16 message words m with
// byte counter t, cut to its first kRounds rounds; writes the digest's four
// u64 words.
template <int kRounds = 12>
__device__ __forceinline__ void blake2b256_block(const uint64_t (&m)[16], uint64_t t, uint64_t (&h)[4]) {
    static_assert(1 <= kRounds && kRounds <= 12, "Blake2b has 12 rounds");
    uint64_t v0 = kH0, v1 = kIV1, v2 = kIV2, v3 = kIV3, v4 = kIV4, v5 = kIV5, v6 = kIV6, v7 = kIV7;
    uint64_t v8 = kIV0, v9 = kIV1, v10 = kIV2, v11 = kIV3;
    uint64_t v12 = kIV4 ^ t, v13 = kIV5, v14 = ~kIV6, v15 = kIV7;
    STARK_BLAKE2B_ROUND(0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    STARK_BLAKE2B_ROUND(1, 14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
    STARK_BLAKE2B_ROUND(2, 11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
    STARK_BLAKE2B_ROUND(3, 7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
    STARK_BLAKE2B_ROUND(4, 9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
    STARK_BLAKE2B_ROUND(5, 2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
    STARK_BLAKE2B_ROUND(6, 12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
    STARK_BLAKE2B_ROUND(7, 13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
    STARK_BLAKE2B_ROUND(8, 6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
    STARK_BLAKE2B_ROUND(9, 10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
    STARK_BLAKE2B_ROUND(10, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
    STARK_BLAKE2B_ROUND(11, 14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
    h[0] = kH0 ^ v0 ^ v8;
    h[1] = kIV1 ^ v1 ^ v9;
    h[2] = kIV2 ^ v2 ^ v10;
    h[3] = kIV3 ^ v3 ^ v11;
}

#undef STARK_BLAKE2B_ROUND

// The (8, w / 2) planar digest words of parent i: lo and hi of each u64.
__device__ __forceinline__ void store_digest(uint32_t* __restrict__ out, int64_t plane, int64_t i,
                                             const uint64_t (&h)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        out[(2 * j) * plane + i] = static_cast<uint32_t>(h[j]);
        out[(2 * j + 1) * plane + i] = static_cast<uint32_t>(h[j] >> 32);
    }
}

// The message block of parent i of the planar (8, w) level: child 2i's
// four u64 words, then child 2i + 1's, the rest zero.
__device__ __forceinline__ void load_children(const uint32_t* __restrict__ in, int64_t w, int64_t i,
                                              uint64_t (&m)[16]) {
#pragma unroll
    for (int j = 0; j < 16; ++j) m[j] = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        m[j] = in[(2 * j) * w + 2 * i] | (static_cast<uint64_t>(in[(2 * j + 1) * w + 2 * i]) << 32);
        m[4 + j] = in[(2 * j) * w + 2 * i + 1] | (static_cast<uint64_t>(in[(2 * j + 1) * w + 2 * i + 1]) << 32);
    }
}

// Parent i of the planar (8, w) level = Blake2b-256(child 2i || child
// 2i + 1), one 64-byte block, the compress cut to kRounds rounds.  At 12
// it is the level kernel K5 (merkle.cu stark_merkle_level), at 1 and 6 the
// roofline probe's round kernel (probes.cu stark_probe_level_rounds): one
// template, so the probe runs K5's code and K5 is built once.
template <int kRounds>
__global__ void level_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t w) {
    const int64_t half = w / 2;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= half) return;
    uint64_t m[16];
    load_children(in, w, i, m);
    uint64_t h[4];
    blake2b256_block<kRounds>(m, 64, h);
    store_digest(out, half, i, h);
}

}  // namespace stark
