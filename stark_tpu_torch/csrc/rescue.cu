// Batched Rescue-Prime permutation (R1) for Hopper.
//
// Computes what the JAX package's XLA-fused permutation_mont / trace_mont
// compute (stark_tpu/ops/rescue.py:92, :104; there is no Pallas form): the
// 27-round Rescue-Prime permutation (m = 2, alpha = 3) of a batch of
// states, and optionally all 28 states of each.  One round:
//
//     cube; MDS mix + first constants; x^(1/3); MDS mix + second constants
//
// with x^(1/3) = x^RESCUE_ALPHA_INV, RESCUE_ALPHA_INV = (2p - 1) / 3.
//
// Design: one thread per instance, its two state elements in registers
// as field.cuh's Fe, every product field.cuh's fe_mul.  The inverse S-box
// is a fixed 4-bit window chain whose windows are derived at compile time
// from the decimal RESCUE_ALPHA_INV (the runs of equal hex digits below the
// top one become loops: 0x87AAAA...AAAB is 8, then 7, 29 A's and a B), the
// powers x^d of the digits that occur built once a call (x^2k = (x^k)^2,
// x^(2k+1) = x^2k * x); the two registers' chains run side by side in one
// thread, so each has the other's instructions to hide its latency.  A
// permutation is 27 x (2 x 164 + 12) = 9,180 products.  The MDS matrix and
// round constants (Montgomery limbs, (8, 112): the matrix row major, then a
// round's four constants) come from a device tensor that the wrapper builds
// once a device, read through the read-only path; no __constant__ symbol.
// In trace mode every state is stored, (28, 8, 2, B); else the last one.
//
// Bound on the card: products, not bytes.  A product is ~137 warp
// instructions issued (PERF.md section 6), so a permutation is ~39,400
// warp instructions a thread: ~9.9 ms for 2^18 instances on 132 SMs at
// 1980 MHz, while its bytes (64 in, 64 or 1,792 out an instance) take
// 0.01-0.14 ms.  A batch of 4096 fills 128 warps, one an SM: it waits for
// one thread's chain of 9,180 dependent products.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using stark::Fe;
using stark::fe_add;
using stark::fe_mul;

constexpr int kThreads = 64;
constexpr int kRounds = 27;         // RESCUE_N
constexpr int kWidth = 2;           // RESCUE_M
constexpr int kConstants = 4 + 4 * kRounds;  // columns of the constants tensor

// RESCUE_ALPHA_INV as two 64-bit halves, parsed from its decimal digits.
struct U128 {
    uint64_t hi, lo;
};

constexpr U128 parse_decimal(const char* s) {
    U128 v{0, 0};
    for (; *s; ++s) {  // v = 10 v + digit
        const uint64_t low = (v.lo & 0xFFFFFFFFull) * 10;
        const uint64_t high = (v.lo >> 32) * 10 + (low >> 32);
        uint64_t lo = (high << 32) | (low & 0xFFFFFFFFull);
        uint64_t hi = v.hi * 10 + (high >> 32);
        const uint64_t d = static_cast<uint64_t>(*s - '0');
        lo += d;
        hi += lo < d;
        v = U128{hi, lo};
    }
    return v;
}

constexpr U128 kAlphaInv = parse_decimal("180331931428153586757283157844700080811");
// scalars, so that device code may read them
constexpr uint64_t kAlphaInvHi = kAlphaInv.hi;
constexpr uint64_t kAlphaInvLo = kAlphaInv.lo;
// 3 * alpha_inv = 2p - 1 == 1 (mod 2^64), as p == 1 (mod 2^64)
static_assert(kAlphaInvLo * 3u == 1u, "RESCUE_ALPHA_INV is not (2p - 1) / 3");

// Hex digit k of the exponent, k = 0 the least significant.
__host__ __device__ constexpr int hex_digit(int k) {
    return static_cast<int>(((k < 16 ? kAlphaInvLo >> (4 * k) : kAlphaInvHi >> (4 * (k - 16)))) & 0xF);
}

__host__ __device__ constexpr int top_digit() {
    int k = 31;
    while (k > 0 && hex_digit(k) == 0) --k;
    return k;
}

// How many digits from k down equal digit k.
__host__ __device__ constexpr int run_length(int k) {
    int n = 1;
    while (k - n >= 0 && hex_digit(k - n) == hex_digit(k)) ++n;
    return n;
}

// x^1 .. x^15; the entries no window uses are dead code.
struct Powers {
    Fe p[16];
};

__device__ __forceinline__ Powers powers_of(const Fe& x) {
    Powers t;
    t.p[1] = x;
#pragma unroll
    for (int k = 2; k < 16; ++k) t.p[k] = (k % 2 == 0) ? fe_mul(t.p[k / 2], t.p[k / 2]) : fe_mul(t.p[k - 1], x);
    return t;
}

// The windows from digit K down: each run of equal digits a loop of
// (4 squarings, times x^digit), both chains side by side.
template <int K>
__device__ __forceinline__ void windows(Fe& a0, Fe& a1, const Powers& t0, const Powers& t1) {
    if constexpr (K >= 0) {
        constexpr int kDigit = hex_digit(K);
        constexpr int kRun = run_length(K);
#pragma unroll 1
        for (int j = 0; j < kRun; ++j) {
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                a0 = fe_mul(a0, a0);
                a1 = fe_mul(a1, a1);
            }
            if constexpr (kDigit != 0) {
                a0 = fe_mul(a0, t0.p[kDigit]);
                a1 = fe_mul(a1, t1.p[kDigit]);
            }
        }
        windows<K - kRun>(a0, a1, t0, t1);
    }
}

// x0^(1/3), x1^(1/3) in place.
__device__ __forceinline__ void inverse_sbox(Fe& x0, Fe& x1) {
    const Powers t0 = powers_of(x0);
    const Powers t1 = powers_of(x1);
    constexpr int kTop = top_digit();
    constexpr int kFirst = hex_digit(kTop);
    x0 = t0.p[kFirst];
    x1 = t1.p[kFirst];
    windows<kTop - 1>(x0, x1, t0, t1);
}

__device__ __forceinline__ Fe cube(const Fe& x) { return fe_mul(fe_mul(x, x), x); }

// One Montgomery element of the constants tensor through the read-only path.
__device__ __forceinline__ Fe constant(const int32_t* __restrict__ c, int column) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t lo = static_cast<uint32_t>(__ldg(c + (2 * k) * kConstants + column));
        const uint32_t hi = static_cast<uint32_t>(__ldg(c + (2 * k + 1) * kConstants + column));
        r.w[k] = (lo & 0xFFFFu) | (hi << 16);
    }
    return r;
}

// state: (8, 2, b); out: (28, 8, 2, b) in trace mode, else (8, 2, b).
__global__ void __launch_bounds__(kThreads) rescue_kernel(const int32_t* __restrict__ state,
                                                          int32_t* __restrict__ out,
                                                          const int32_t* __restrict__ consts, int64_t b,
                                                          int trace) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= b) return;
    const int64_t plane = kWidth * b;   // a limb plane of one state
    const int64_t step = 8 * plane;     // one state of the trace
    Fe s0 = stark::fe_load(state, plane, i);
    Fe s1 = stark::fe_load(state, plane, b + i);
    if (trace) {
        stark::fe_store(out, plane, i, s0);
        stark::fe_store(out, plane, b + i, s1);
    }
#pragma unroll 1
    for (int r = 0; r < kRounds; ++r) {
        const Fe m00 = constant(consts, 0), m01 = constant(consts, 1);
        const Fe m10 = constant(consts, 2), m11 = constant(consts, 3);
        const Fe a0 = cube(s0), a1 = cube(s1);
        Fe t0 = fe_add(fe_add(fe_mul(m00, a0), fe_mul(m01, a1)), constant(consts, 4 + 4 * r));
        Fe t1 = fe_add(fe_add(fe_mul(m10, a0), fe_mul(m11, a1)), constant(consts, 5 + 4 * r));
        inverse_sbox(t0, t1);
        s0 = fe_add(fe_add(fe_mul(m00, t0), fe_mul(m01, t1)), constant(consts, 6 + 4 * r));
        s1 = fe_add(fe_add(fe_mul(m10, t0), fe_mul(m11, t1)), constant(consts, 7 + 4 * r));
        if (trace) {
            int32_t* row = out + (r + 1) * step;
            stark::fe_store(row, plane, i, s0);
            stark::fe_store(row, plane, b + i, s1);
        }
    }
    if (!trace) {
        stark::fe_store(out, plane, i, s0);
        stark::fe_store(out, plane, b + i, s1);
    }
}

}  // namespace

// state: (8, 2, b) Montgomery limbs; out: (28, 8, 2, b) if trace, else
// (8, 2, b); consts: (8, 112) Montgomery limbs (MDS row major, then per
// round c1_0, c1_1, c2_0, c2_1).
extern "C" int stark_rescue_permutation(const int32_t* state, int32_t* out, const int32_t* consts, int64_t b,
                                        int trace, void* stream) {
    if (b <= 0) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((b + kThreads - 1) / kThreads);
    rescue_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(state, out, consts, b, trace);
    return cudaGetLastError();
}
