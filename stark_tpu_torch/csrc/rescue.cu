// Batched Rescue-Prime permutation (R1) for Hopper.
//
// Computes what the JAX package's XLA-fused permutation_mont / trace_mont
// compute (stark_tpu/ops/rescue.py:92, :104; there is no Pallas form): the
// 27-round Rescue-Prime permutation (m = 2, alpha = 3) of a batch of
// states, and optionally all 28 states of each.  One round:
//
//     cube; MDS mix + first constants; x^(1/3); MDS mix + second constants
//
// with x^(1/3) = x^RESCUE_ALPHA_INV, RESCUE_ALPHA_INV = (2p - 1) / 3 =
// 0x87 AA...AA AB (fourteen 0xAA bytes).
//
// Bound on the card: products, not bytes (64 bytes in, 64 or 1,792 out an
// instance).  Design, one thread an instance, its two state elements in
// registers as field.cuh's Fe:
// - the inverse S-box is the chain of kSetup and kWindows below: 149
//   products, 128 of them squarings (Schoenhage's lower bound for this
//   exponent is 131), against the 164 of a 4-bit window chain; only x,
//   x^170 and the accumulator stay live through its windows;
// - squarings are field.cuh's fe_sqr (10 partial products), the other
//   products fe_mul_scan (16); both form their partial products first, so
//   one product's dependent path is its column sums and fe_redc's one-step
//   reduction, not fe_mul's four serial CIOS rounds;
// - the two state elements' chains run side by side in one thread, so each
//   has the other's instructions to issue while it waits;
// - the MDS matrix is read once into registers; a round's four constants
//   come from the constants tensor ((8, 112) Montgomery limbs: the matrix
//   row major, then a round's c1_0, c1_1, c2_0, c2_1) through the read-only
//   path.
// A permutation is 27 x (2 x 149 + 2 x 2 + 8) = 8,370 products, 6,966 of
// them squarings.  A batch of 4096 fills 128 warps, so it waits on one
// thread's chain: 27 x 148 dependent products (cube 2, mix 1, S-box 144,
// mix 1).  In trace mode every state is stored, (28, 8, 2, B); else the
// last one.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

using stark::Fe;
using stark::fe_add;
using stark::fe_mul_scan;
using stark::fe_sqr;

constexpr int kThreads = 64;
constexpr int kRounds = 27;         // RESCUE_N
constexpr int kWidth = 2;           // RESCUE_M
constexpr int kConstants = 4 + 4 * kRounds;  // columns of the constants tensor

// The inverse S-box's chain, x^RESCUE_ALPHA_INV, on registers v[0..3] with
// v[0] = x on entry.  kSetup runs first, each step v[dst] = v[a] * v[b] (a
// squaring when a == b); then each run of kWindows, `repeat` times:
// v[kAcc] = v[kAcc]^(2^squarings) * v[factor].  The result is v[kAcc].
// tests/test_torch_rescue.py and chip_smoke.py read both tables from here.
struct Step {
    int dst, a, b;
};
struct Window {
    int squarings, factor, repeat;
};
constexpr int kRegisters = 4;
constexpr int kAcc = 2;
constexpr int kSetupSteps = 13;
constexpr int kWindowRuns = 2;
constexpr int kSquaringUnroll = 4;  // squarings of each chain a pass of the windows' inner loop

__host__ __device__ constexpr Step setup_step(int k) {
    constexpr Step kSetup[kSetupSteps] = {
        {1, 0, 0},  // x^2
        {2, 1, 1},  // x^4
        {3, 2, 0},  // x^5
        {1, 3, 1},  // x^7
        {2, 2, 2},  // x^8
        {2, 2, 2},  // x^16
        {3, 2, 3},  // x^21
        {2, 2, 2},  // x^32
        {2, 2, 2},  // x^64
        {3, 2, 3},  // x^85
        {2, 2, 2},  // x^128
        {2, 2, 1},  // x^135 = x^0x87, the accumulator
        {1, 3, 3},  // x^170 = x^0xAA
    };
    return kSetup[k];
}

__host__ __device__ constexpr Window window_run(int k) {
    constexpr Window kWindows[kWindowRuns] = {
        {8, 1, 15},  // fifteen bytes 0xAA
        {0, 0, 1},   // + 1: the last byte is 0xAB
    };
    return kWindows[k];
}

static_assert(window_run(0).squarings % kSquaringUnroll == 0 && window_run(1).squarings % kSquaringUnroll == 0,
              "a window's squarings are whole passes of its inner loop");

template <int K>
__device__ __forceinline__ void setup(Fe (&v0)[kRegisters], Fe (&v1)[kRegisters]) {
    if constexpr (K < kSetupSteps) {
        constexpr Step s = setup_step(K);
        if constexpr (s.a == s.b) {
            v0[s.dst] = fe_sqr(v0[s.a]);
            v1[s.dst] = fe_sqr(v1[s.a]);
        } else {
            v0[s.dst] = fe_mul_scan(v0[s.a], v0[s.b]);
            v1[s.dst] = fe_mul_scan(v1[s.a], v1[s.b]);
        }
        setup<K + 1>(v0, v1);
    }
}

template <int K>
__device__ __forceinline__ void windows(Fe (&v0)[kRegisters], Fe (&v1)[kRegisters]) {
    if constexpr (K < kWindowRuns) {
        constexpr Window w = window_run(K);
#pragma unroll 1
        for (int j = 0; j < w.repeat; ++j) {
#pragma unroll 1
            for (int s = 0; s < w.squarings / kSquaringUnroll; ++s) {
#pragma unroll
                for (int u = 0; u < kSquaringUnroll; ++u) {
                    v0[kAcc] = fe_sqr(v0[kAcc]);
                    v1[kAcc] = fe_sqr(v1[kAcc]);
                }
            }
            v0[kAcc] = fe_mul_scan(v0[kAcc], v0[w.factor]);
            v1[kAcc] = fe_mul_scan(v1[kAcc], v1[w.factor]);
        }
        windows<K + 1>(v0, v1);
    }
}

// x0^(1/3), x1^(1/3) in place.
__device__ __forceinline__ void inverse_sbox(Fe& x0, Fe& x1) {
    Fe v0[kRegisters], v1[kRegisters];
    v0[0] = x0;
    v1[0] = x1;
    setup<0>(v0, v1);
    windows<0>(v0, v1);
    x0 = v0[kAcc];
    x1 = v1[kAcc];
}

__device__ __forceinline__ Fe cube(const Fe& x) { return fe_mul_scan(fe_sqr(x), x); }

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
    const Fe m00 = constant(consts, 0), m01 = constant(consts, 1);
    const Fe m10 = constant(consts, 2), m11 = constant(consts, 3);
#pragma unroll 1
    for (int r = 0; r < kRounds; ++r) {
        const Fe a0 = cube(s0), a1 = cube(s1);
        Fe t0 = fe_add(fe_add(fe_mul_scan(m00, a0), fe_mul_scan(m01, a1)), constant(consts, 4 + 4 * r));
        Fe t1 = fe_add(fe_add(fe_mul_scan(m10, a0), fe_mul_scan(m11, a1)), constant(consts, 5 + 4 * r));
        inverse_sbox(t0, t1);
        s0 = fe_add(fe_add(fe_mul_scan(m00, t0), fe_mul_scan(m01, t1)), constant(consts, 6 + 4 * r));
        s1 = fe_add(fe_add(fe_mul_scan(m10, t0), fe_mul_scan(m11, t1)), constant(consts, 7 + 4 * r));
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
