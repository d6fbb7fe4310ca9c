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
// A round's transcript is a few hundred bytes, a handful of permutations,
// and Keccak-f[1600] is a sequential chain of 24 rounds: the launch is
// bound by the latency of that chain, not by bytes or operations.  Design:
// one warp, one Keccak lane a thread.  Lane i = x + 5y holds state lane i
// as a native uint64_t in a register, and a round is 9 warp shuffles of
// 64 bits in three dependent steps: theta's column parity C[x] from the
// column's four other lanes, then C[x - 1] and C[x + 1]; after rho, which
// rotates each lane by its own amount with two funnel shifts, pi and chi
// in one step, each lane gathering the three rotated lanes that chi
// combines into it.  Every lane runs every shuffle with the full mask;
// lanes 25-31 carry values nobody reads.  No state is indexed at run time, so nothing lives in local
// memory.  The message is staged in shared memory a chunk of rate blocks
// at a time, with coalesced byte loads; lanes 0-16 then read their 8-byte
// words of each block from there.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kRate = 136;       // Shake256 rate in bytes (17 lanes)
constexpr int kRateLanes = kRate / 8;
constexpr int kAppended = 72;    // le64 length + 64 hex digits
constexpr int kStageBlocks = 8;  // rate blocks staged at once: the cascade's messages fit one chunk
constexpr unsigned kAll = 0xFFFFFFFFu;

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};
// rho rotation of lane x + 5y, and pi's source: lane j takes lane kPiSrc[j]
// (pi moves lane i = x + 5y to lane y + 5 * ((2x + 3y) mod 5))
__constant__ int kRho[25] = {0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56, 14};
__constant__ int kPiSrc[25] = {0, 6, 12, 18, 24, 3, 9, 10, 16, 22, 1, 7, 13, 19, 20, 4, 5, 11, 17, 23, 2, 8, 14, 15, 21};

// rotl(v, amount) with amount = 32 * swap + n, n < 32: two funnel shifts on
// the halves, no branch
__device__ __forceinline__ uint64_t rotl_halves(uint64_t v, bool swap, uint32_t n) {
    const uint32_t lo = static_cast<uint32_t>(v), hi = static_cast<uint32_t>(v >> 32);
    const uint32_t l = swap ? hi : lo, h = swap ? lo : hi;
    return (static_cast<uint64_t>(__funnelshift_l(l, h, n)) << 32) | __funnelshift_l(h, l, n);
}

// Byte k of le64(64) || hex(root), root as 8 little-endian u32 words.
__device__ __forceinline__ uint32_t appended_byte(const uint32_t* __restrict__ root, int k) {
    if (k < 8) return k == 0 ? 64u : 0u;
    const int d = (k - 8) >> 1;  // digest byte: high nibble first
    const uint32_t byte = (root[d >> 2] >> (8 * (d & 3))) & 0xFFu;
    const uint32_t nibble = k & 1 ? byte & 0xFu : byte >> 4;
    return nibble < 10 ? '0' + nibble : 'a' + nibble - 10;
}

// Little-endian 32-bit word w of a 16-byte big-endian integer at bytes[0..16).
__device__ __forceinline__ uint32_t be_word(const uint8_t* bytes, int w) {
    return static_cast<uint32_t>(bytes[15 - 4 * w]) | (static_cast<uint32_t>(bytes[14 - 4 * w]) << 8) |
           (static_cast<uint32_t>(bytes[13 - 4 * w]) << 16) | (static_cast<uint32_t>(bytes[12 - 4 * w]) << 24);
}

__global__ void __launch_bounds__(kLanes) fs_round_kernel(uint8_t* __restrict__ body, int64_t body_len,
                                                          uint64_t count, const uint32_t* __restrict__ root,
                                                          int32_t* __restrict__ alpha) {
    __shared__ uint64_t stage[kStageBlocks * kRateLanes];
    const int lane = threadIdx.x;

    // 1. the appended bytes, in place; the hash below computes them again
    // from the root instead of reading them back
    for (int k = lane; k < kAppended; k += kLanes) body[body_len + k] = static_cast<uint8_t>(appended_byte(root, k));

    // per-lane constants of the round: the columns theta reads, the rho
    // rotation, the sources of chi's three operands B[x + k, y] (k = 0, 1,
    // 2) through pi, and iota's lane; lanes 25-31 read lanes of their own
    const int x = lane % 5, y = lane / 5;
    const int left = (x + 4) % 5, right = (x + 1) % 5;
    const bool live = lane < 25;
    const uint64_t iota_mask = lane == 0 ? ~0ull : 0ull;
    const int rho = live ? kRho[lane] : 0;
    const bool rho_swap = rho >= 32;
    const uint32_t rho_n = rho & 31;
    const int chi0 = live ? kPiSrc[lane] : lane;
    const int chi1 = live ? kPiSrc[5 * y + right] : lane, chi2 = live ? kPiSrc[5 * y + (x + 2) % 5] : lane;

    // 2. Shake256(le64(count) || body[0 : body_len + 72]) with pad10*1
    const int64_t msg_len = 8 + body_len + kAppended;
    const int64_t blocks = msg_len / kRate + 1;
    const int64_t pad_last = blocks * kRate - 1;
    uint8_t* staged = reinterpret_cast<uint8_t*>(stage);
    uint64_t a = 0;
    for (int64_t chunk = 0; chunk < blocks; chunk += kStageBlocks) {
        const int64_t first = chunk * kRate;
        const int n_blocks = static_cast<int>(blocks - chunk < kStageBlocks ? blocks - chunk : kStageBlocks);
        for (int p = lane; p < n_blocks * kRate; p += kLanes) {
            const int64_t idx = first + p;
            uint32_t byte = idx < 8 ? static_cast<uint32_t>(count >> (8 * idx)) & 0xFFu
                            : idx < 8 + body_len ? body[idx - 8]
                            : idx < msg_len ? appended_byte(root, static_cast<int>(idx - 8 - body_len)) : 0u;
            if (idx == msg_len) byte ^= 0x1Fu;
            if (idx == pad_last) byte ^= 0x80u;
            staged[p] = static_cast<uint8_t>(byte);
        }
        __syncwarp();
        for (int b = 0; b < n_blocks; ++b) {
            if (lane < kRateLanes) a ^= stage[b * kRateLanes + lane];
            uint64_t rc = kRC[0];  // loaded a round ahead, off the chain
#pragma unroll 1
            for (int r = 0; r < 24; ++r) {
                // theta: C[x] from the column's other lanes, then a ^= C[x - 1] ^ rotl(C[x + 1], 1)
                uint64_t c = a;
#pragma unroll
                for (int k = 5; k < 25; k += 5) c ^= __shfl_sync(kAll, a, (lane + k) % 25);
                const uint64_t c_left = __shfl_sync(kAll, c, left), c_right = __shfl_sync(kAll, c, right);
                a ^= c_left ^ ((c_right << 1) | (c_right >> 63));
                // rho on each lane, then pi and chi: A[x, y] = B[x, y] ^ (~B[x + 1, y] & B[x + 2, y]),
                // each B a rotated lane of its pi source; iota on lane 0
                const uint64_t rotated = rotl_halves(a, rho_swap, rho_n);
                const uint64_t b0 = __shfl_sync(kAll, rotated, chi0), b1 = __shfl_sync(kAll, rotated, chi1),
                               b2 = __shfl_sync(kAll, rotated, chi2);
                a = b0 ^ (~b1 & b2) ^ (rc & iota_mask);
                rc = kRC[r < 23 ? r + 1 : 0];
            }
        }
        __syncwarp();  // the next chunk overwrites the staged blocks
    }

    // 3. squeeze: lanes 0-3 hold the 32 output bytes; lane 0 samples alpha
    uint64_t out[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = __shfl_sync(kAll, a, k);
    if (lane != 0) return;
    uint8_t fs[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) fs[k] = static_cast<uint8_t>(out[k / 8] >> (8 * (k % 8)));

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
    fs_round_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
        body, body_len, count, reinterpret_cast<const uint32_t*>(root), alpha);
    return cudaGetLastError();
}
