// One Fiat-Shamir round of the fused FRI commit cascade, on the card.
//
// Stands in for the XLA-fused device Shake256 and transcript code of the
// JAX package (stark_tpu/ops/device_keccak.py shake256_words and
// stark_tpu/ops/device_fs.py hex_words / alpha_mont_from_fs), which have
// no Pallas kernel.  In one launch it
//
//   1. appends bincode(hex(root)) = le64(64) || 64 lowercase hex digits of
//      the Merkle root to the device transcript body (in place);
//   2. hashes le64(count) || body with Shake256 (FIPS 202, rate 136 bytes,
//      domain byte 0x1f) and squeezes 32 bytes: the prover's Fiat-Shamir
//      draw (reference: proof_stream.rs:50-58);
//   3. samples the fold challenge alpha = big-endian fold of those bytes
//      mod p (field.rs:110-116) and writes it as an (8, 1) Montgomery limb
//      column for the fold kernel (fold.cu).
//
// Design: one block.  72 threads write the appended bytes, then one thread
// absorbs and permutes: Keccak-f[1600] is a strictly sequential chain of
// 24 rounds on 25 native 64-bit lanes held in registers.  A round's
// transcript is a few hundred bytes (a handful of permutations), so the
// launch is bound by its latency, not by bytes or operations.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRate = 136;       // Shake256 rate in bytes (17 lanes)
constexpr int kAppended = 72;    // le64 length + 64 hex digits

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};
// rho rotation of lane x + 5y, and pi: lane i moves to lane kPi[i]
__constant__ int kRho[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
__constant__ int kPi[25] = {0, 10, 20, 5, 15, 16, 1, 11, 21, 6, 7, 17, 2, 12, 22, 23, 8, 18, 3, 13, 14, 24, 9, 19, 4};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) { return n ? (x << n) | (x >> (64 - n)) : x; }

__device__ void keccak_f1600(uint64_t (&a)[25]) {
    for (int r = 0; r < 24; ++r) {
        uint64_t c[5];
#pragma unroll
        for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
        for (int x = 0; x < 5; ++x) {
            const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
            for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
        }
        uint64_t b[25];
#pragma unroll
        for (int i = 0; i < 25; ++i) b[kPi[i]] = rotl64(a[i], kRho[i]);
#pragma unroll
        for (int y = 0; y < 25; y += 5) {
#pragma unroll
            for (int x = 0; x < 5; ++x) a[x + y] = b[x + y] ^ (~b[(x + 1) % 5 + y] & b[(x + 2) % 5 + y]);
        }
        a[0] ^= kRC[r];
    }
}

// Little-endian 32-bit word w of a 16-byte big-endian integer at bytes[0..16).
__device__ __forceinline__ uint32_t be_word(const uint8_t* bytes, int w) {
    return static_cast<uint32_t>(bytes[15 - 4 * w]) | (static_cast<uint32_t>(bytes[14 - 4 * w]) << 8) |
           (static_cast<uint32_t>(bytes[13 - 4 * w]) << 16) | (static_cast<uint32_t>(bytes[12 - 4 * w]) << 24);
}

__global__ void fs_round_kernel(uint8_t* __restrict__ body, int64_t body_len, uint64_t count,
                                const uint32_t* __restrict__ root, int32_t* __restrict__ alpha) {
    const int t = threadIdx.x;
    if (t < 8) {
        body[body_len + t] = t == 0 ? 64 : 0;
    } else if (t < kAppended) {
        const int k = (t - 8) / 2;  // digest byte
        const uint32_t byte = (root[k / 4] >> (8 * (k % 4))) & 0xFFu;
        const uint32_t nibble = (t - 8) % 2 == 0 ? byte >> 4 : byte & 0xFu;
        body[body_len + t] = static_cast<uint8_t>(nibble < 10 ? '0' + nibble : 'a' + nibble - 10);
    }
    __syncthreads();
    if (t != 0) return;

    // Shake256(le64(count) || body[0 : body_len + 72]) with pad10*1
    const int64_t msg_len = 8 + body_len + kAppended;
    const int64_t padded_len = (msg_len / kRate + 1) * kRate;
    uint64_t st[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) st[i] = 0;
    for (int64_t blk = 0; blk < padded_len; blk += kRate) {
        for (int lane = 0; lane < kRate / 8; ++lane) {
            uint64_t w = 0;
            for (int j = 0; j < 8; ++j) {
                const int64_t idx = blk + 8 * lane + j;
                uint32_t byte = idx < 8 ? static_cast<uint32_t>(count >> (8 * idx)) & 0xFFu
                                : idx < msg_len ? body[idx - 8] : 0u;
                if (idx == msg_len) byte ^= 0x1Fu;
                if (idx == padded_len - 1) byte ^= 0x80u;
                w |= static_cast<uint64_t>(byte) << (8 * j);
            }
            st[lane] ^= w;
        }
        keccak_f1600(st);
    }
    uint8_t fs[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) fs[k] = static_cast<uint8_t>(st[k / 8] >> (8 * (k % 8)));

    // alpha = (hi * 2^128 + lo) mod p with hi, lo the big-endian halves:
    // hi * 2^128 mod p is the Montgomery product of hi and R^2 (hi < 2^128,
    // R^2 < p, so the product stays below 2p), lo < 2^128 < 2p needs one
    // conditional subtraction; one more product by R^2 gives Montgomery form.
    const stark::Fe r2{{0x0E778236u, 0x5BD53A7Fu, 0x1A6AEDC2u, 0xAAF4AD9Au}};
    const stark::Fe hi{{be_word(fs, 0), be_word(fs, 1), be_word(fs, 2), be_word(fs, 3)}};
    const stark::Fe hi_r = stark::fe_mul(hi, r2);
    const stark::Fe lo_r = stark::fe_reduce_once(be_word(fs + 16, 0), be_word(fs + 16, 1), be_word(fs + 16, 2),
                                                 be_word(fs + 16, 3), 0u);
    stark::fe_store(alpha, 1, 0, stark::fe_mul(stark::fe_add(hi_r, lo_r), r2));
}

}  // namespace

// body: uint8 device buffer holding the transcript body (the serialized
// proof stream without its leading u64 count) in [0, body_len), with room
// for 72 more bytes; root: (8,) u32 digest words; alpha: (8, 1) limbs.
extern "C" int stark_fs_round(uint8_t* body, int64_t body_len, uint64_t count, const int32_t* root, int32_t* alpha,
                              void* stream) {
    if (body_len < 0) return cudaErrorInvalidValue;
    fs_round_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        body, body_len, count, reinterpret_cast<const uint32_t*>(root), alpha);
    return cudaGetLastError();
}
