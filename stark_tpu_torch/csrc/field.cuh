// GF(p) arithmetic for the card's kernels, p = 1 + 407 * 2^119.
//
// Counterpart of the in-kernel field helpers of the TPU kernels
// (stark_tpu/ops/pallas_fold.py: _k_mont_mul, _k_add, _k_sub).  Those work
// on eight 16-bit limbs because the TPU has no 64-bit integer path; here an
// element is four little-endian 32-bit words and every partial product is a
// 32x32->64 multiply.  Montgomery form keeps R = 2^128, the same radix as
// the 8 x 16-bit limb format, so Montgomery values agree bit for bit.  Only
// loads and stores see the 16-bit limb layout of the tensors
// (limb l of element i at limbs[l * plane + i]).
//
// p = 1 + 0xCB800000 * 2^96, so p == 1 (mod 2^32): the CIOS quotient is
// m = -t0 mod 2^32, and m * p touches only words 0 and 3.  All results are
// canonical (< p) for canonical inputs.
#pragma once

#include <cstdint>

namespace stark {

struct alignas(16) Fe {  // 16-byte aligned: one vector load or store in shared memory
    uint32_t w[4];
};

constexpr uint32_t kPTop = 0xCB800000u;  // word 3 of p; words 1, 2 are 0, word 0 is 1

__device__ __forceinline__ Fe fe_load(const int32_t* __restrict__ limbs, int64_t plane, int64_t i) {
    Fe r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t lo = static_cast<uint32_t>(limbs[(2 * k) * plane + i]);
        const uint32_t hi = static_cast<uint32_t>(limbs[(2 * k + 1) * plane + i]);
        r.w[k] = (lo & 0xFFFFu) | (hi << 16);
    }
    return r;
}

__device__ __forceinline__ void fe_store(int32_t* __restrict__ limbs, int64_t plane, int64_t i, const Fe& a) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        limbs[(2 * k) * plane + i] = static_cast<int32_t>(a.w[k] & 0xFFFFu);
        limbs[(2 * k + 1) * plane + i] = static_cast<int32_t>(a.w[k] >> 16);
    }
}

// (top * 2^128 + t) - p if that is >= 0, else t.  Requires the value < 2p.
__device__ __forceinline__ Fe fe_reduce_once(uint32_t t0, uint32_t t1, uint32_t t2, uint32_t t3, uint32_t top) {
    const uint32_t d0 = t0 - 1u;
    const uint32_t b0 = t0 < 1u;
    const uint32_t d1 = t1 - b0;
    const uint32_t b1 = t1 < b0;
    const uint32_t d2 = t2 - b1;
    const uint32_t b2 = t2 < b1;
    const uint64_t need = static_cast<uint64_t>(kPTop) + b2;
    const uint32_t d3 = static_cast<uint32_t>(static_cast<uint64_t>(t3) - need);
    const uint32_t b3 = static_cast<uint64_t>(t3) < need;
    Fe r;
    if (top >= b3) {  // no borrow out of the top: value >= p
        r.w[0] = d0; r.w[1] = d1; r.w[2] = d2; r.w[3] = d3;
    } else {
        r.w[0] = t0; r.w[1] = t1; r.w[2] = t2; r.w[3] = t3;
    }
    return r;
}

// Montgomery product a * b * 2^-128 mod p (CIOS over 32-bit words).
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
    uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0;  // t < 2p between steps
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint64_t bi = b.w[i];
        uint64_t s;
        s = a.w[0] * bi + t0;             t0 = static_cast<uint32_t>(s);
        s = a.w[1] * bi + t1 + (s >> 32); t1 = static_cast<uint32_t>(s);
        s = a.w[2] * bi + t2 + (s >> 32); t2 = static_cast<uint32_t>(s);
        s = a.w[3] * bi + t3 + (s >> 32); t3 = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(t4) + (s >> 32);
        t4 = static_cast<uint32_t>(s);
        const uint32_t t5 = static_cast<uint32_t>(s >> 32);
        // t += m * p with m = -t0 mod 2^32; the low word becomes 0
        const uint32_t m = 0u - t0;
        s = static_cast<uint64_t>(t0) + m;
        s = static_cast<uint64_t>(t1) + (s >> 32);                        const uint32_t u0 = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(t2) + (s >> 32);                        const uint32_t u1 = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(m) * kPTop + t3 + (s >> 32);            const uint32_t u2 = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(t4) + (s >> 32);                        const uint32_t u3 = static_cast<uint32_t>(s);
        const uint32_t u4 = t5 + static_cast<uint32_t>(s >> 32);
        // shifted one word right
        t0 = u0; t1 = u1; t2 = u2; t3 = u3; t4 = u4;
    }
    return fe_reduce_once(t0, t1, t2, t3, t4);
}

// ---- R1's products: carry chains, a one-step reduction --------------------
//
// 32-bit additions and subtractions with the carry (borrow) flag, one PTX
// instruction each (one IADD3 with its carry in a predicate), as CGBN
// writes them: the flag passes from one to the next within a chain, and no
// code the compiler generates between them touches it.  Without nvcc (a g++
// build that runs the kernels' code on the host) the flag is a variable.
#ifdef __CUDACC__
#define STARK_CARRY_OP(name, op)                                                      \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {               \
        uint32_t d;                                                                   \
        asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));                   \
        return d;                                                                     \
    }
STARK_CARRY_OP(add_cc, "add.cc.u32")
STARK_CARRY_OP(addc_cc, "addc.cc.u32")
STARK_CARRY_OP(addc, "addc.u32")
STARK_CARRY_OP(sub_cc, "sub.cc.u32")
STARK_CARRY_OP(subc_cc, "subc.cc.u32")
STARK_CARRY_OP(subc, "subc.u32")
#undef STARK_CARRY_OP
#else
inline thread_local uint32_t carry_flag = 0;
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
    const uint64_t s = static_cast<uint64_t>(a) + b + carry_flag;
    carry_flag = static_cast<uint32_t>(s >> 32);
    return static_cast<uint32_t>(s);
}
inline uint32_t add_cc(uint32_t a, uint32_t b) {
    carry_flag = 0;
    return addc_cc(a, b);
}
inline uint32_t addc(uint32_t a, uint32_t b) { return static_cast<uint32_t>(static_cast<uint64_t>(a) + b + carry_flag); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
    const uint64_t need = static_cast<uint64_t>(b) + carry_flag;
    carry_flag = static_cast<uint64_t>(a) < need;
    return static_cast<uint32_t>(static_cast<uint64_t>(a) - need);
}
inline uint32_t sub_cc(uint32_t a, uint32_t b) {
    carry_flag = 0;
    return subc_cc(a, b);
}
inline uint32_t subc(uint32_t a, uint32_t b) { return static_cast<uint32_t>(static_cast<uint64_t>(a) - b - carry_flag); }
#endif

__device__ __forceinline__ uint64_t wide(uint32_t a, uint32_t b) { return static_cast<uint64_t>(a) * b; }
__device__ __forceinline__ uint32_t lo(uint64_t x) { return static_cast<uint32_t>(x); }
__device__ __forceinline__ uint32_t hi(uint64_t x) { return static_cast<uint32_t>(x >> 32); }

// One-step Montgomery reduction of a 256-bit T = (t[0..7]) < p * 2^128:
// T * 2^-128 mod p, canonical.  p == 1 (mod 2^119), so p^-1 == 1 - 407 *
// 2^119 (mod 2^128) and the Montgomery quotient of the whole low half is one
// step,
//
//     m = T_lo * p^-1 = T_lo - c * 2^119 (mod 2^128),   c = 407 * T mod 2^9,
//
// where c * 2^119 = lo(t0 * kPTop) * 2^96: m is T_lo with that subtracted
// from word 3, b the borrow.  m * p == T_lo (mod 2^128), so
//
//     (T - m * p) / 2^128 = T_hi - b - (m * kPTop) / 2^32,
//
// exactly (the low word of m * kPTop is lo(t0 * kPTop)), and in (-p, p): the
// last step adds p where it is negative.  This is the quotient of the
// classical m = -T_lo * p^-1 with its sign flipped: m takes one subtraction,
// and the result needs no compare before its correction.
__device__ __forceinline__ Fe fe_redc(const uint32_t (&t)[8]) {
    const uint32_t m3 = sub_cc(t[3], t[0] * kPTop);  // the flag holds b
    const uint32_t h0 = hi(wide(t[0], kPTop));
    const uint64_t q1 = wide(t[1], kPTop), q2 = wide(t[2], kPTop), q3 = wide(m3, kPTop);
    // r = T_hi - b - (the high words of m_k * kPTop) - (their low words, from word 1)
    uint32_t r0 = subc_cc(t[4], h0);
    uint32_t r1 = subc_cc(t[5], hi(q1));
    uint32_t r2 = subc_cc(t[6], hi(q2));
    uint32_t r3 = subc_cc(t[7], hi(q3));
    uint32_t r4 = subc(0u, 0u);
    r0 = sub_cc(r0, lo(q1));
    r1 = subc_cc(r1, lo(q2));
    r2 = subc_cc(r2, lo(q3));
    r3 = subc_cc(r3, 0u);
    r4 = subc(r4, 0u);  // 0, or all ones where r < 0: then add p = (1, 0, 0, kPTop)
    Fe out;
    out.w[0] = add_cc(r0, r4 & 1u);
    out.w[1] = addc_cc(r1, 0u);
    out.w[2] = addc_cc(r2, 0u);
    out.w[3] = addc(r3, r4 & kPTop);
    return out;
}

// Montgomery product a * b * 2^-128 mod p by product scanning: the 16
// partial products a_i * b_j first (independent of one another), then their
// sums, then fe_redc.  The products whose i + j have one parity sit side by
// side without overlap (a_0 b_0 | a_1 b_1 | a_2 b_2 | a_3 b_3, and so on),
// so T is six such rows added in six carry chains.
__device__ __forceinline__ Fe fe_mul_scan(const Fe& a, const Fe& b) {
    uint64_t p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] = wide(a.w[i], b.w[j]);
    uint32_t t[8];
    t[0] = lo(p[0][0]);  // p00 | p11 | p22 | p33 + p01 | p12 | p23 (words 1-6)
    t[1] = add_cc(hi(p[0][0]), lo(p[0][1]));
    t[2] = addc_cc(lo(p[1][1]), hi(p[0][1]));
    t[3] = addc_cc(hi(p[1][1]), lo(p[1][2]));
    t[4] = addc_cc(lo(p[2][2]), hi(p[1][2]));
    t[5] = addc_cc(hi(p[2][2]), lo(p[2][3]));
    t[6] = addc_cc(lo(p[3][3]), hi(p[2][3]));
    t[7] = addc(hi(p[3][3]), 0u);
    t[1] = add_cc(t[1], lo(p[1][0]));  // + p10 | p21 | p32 (words 1-6)
    t[2] = addc_cc(t[2], hi(p[1][0]));
    t[3] = addc_cc(t[3], lo(p[2][1]));
    t[4] = addc_cc(t[4], hi(p[2][1]));
    t[5] = addc_cc(t[5], lo(p[3][2]));
    t[6] = addc_cc(t[6], hi(p[3][2]));
    t[7] = addc(t[7], 0u);
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // + p02 | p13, then p20 | p31 (words 2-5)
        const uint64_t u = k ? p[2][0] : p[0][2], v = k ? p[3][1] : p[1][3];
        t[2] = add_cc(t[2], lo(u));
        t[3] = addc_cc(t[3], hi(u));
        t[4] = addc_cc(t[4], lo(v));
        t[5] = addc_cc(t[5], hi(v));
        t[6] = addc_cc(t[6], 0u);
        t[7] = addc(t[7], 0u);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {  // + p03, then p30 (words 3-4)
        const uint64_t u = k ? p[3][0] : p[0][3];
        t[3] = add_cc(t[3], lo(u));
        t[4] = addc_cc(t[4], hi(u));
        t[5] = addc_cc(t[5], 0u);
        t[6] = addc_cc(t[6], 0u);
        t[7] = addc(t[7], 0u);
    }
    return fe_redc(t);
}

// Montgomery square a^2 * 2^-128 mod p: 10 partial products (the 4 squares
// a_i^2 and the 6 cross products a_i a_j, i < j) in place of fe_mul_scan's
// 16.  The cross products sum to X = sum a_i a_j 2^(32(i+j)) < 2^224 in two
// chains (p01 | p03 | p23 + p02 | p13, then + p12); then T = D + 2X, D =
// a_0^2 | a_1^2 | a_2^2 | a_3^2 and 2X by funnel shifts, in one chain.
__device__ __forceinline__ Fe fe_sqr(const Fe& a) {
    const uint64_t p01 = wide(a.w[0], a.w[1]), p02 = wide(a.w[0], a.w[2]), p03 = wide(a.w[0], a.w[3]);
    const uint64_t p12 = wide(a.w[1], a.w[2]), p13 = wide(a.w[1], a.w[3]), p23 = wide(a.w[2], a.w[3]);
    const uint64_t d0 = wide(a.w[0], a.w[0]), d1 = wide(a.w[1], a.w[1]);
    const uint64_t d2 = wide(a.w[2], a.w[2]), d3 = wide(a.w[3], a.w[3]);
    const uint32_t x1 = lo(p01);
    uint32_t x2 = add_cc(hi(p01), lo(p02));
    uint32_t x3 = addc_cc(lo(p03), hi(p02));
    uint32_t x4 = addc_cc(hi(p03), lo(p13));
    uint32_t x5 = addc_cc(lo(p23), hi(p13));
    uint32_t x6 = addc(hi(p23), 0u);
    x3 = add_cc(x3, lo(p12));
    x4 = addc_cc(x4, hi(p12));
    x5 = addc_cc(x5, 0u);
    x6 = addc(x6, 0u);
    uint32_t t[8];
    t[0] = lo(d0);
    t[1] = add_cc(hi(d0), x1 << 1);
    t[2] = addc_cc(lo(d1), (x2 << 1) | (x1 >> 31));
    t[3] = addc_cc(hi(d1), (x3 << 1) | (x2 >> 31));
    t[4] = addc_cc(lo(d2), (x4 << 1) | (x3 >> 31));
    t[5] = addc_cc(hi(d2), (x5 << 1) | (x4 >> 31));
    t[6] = addc_cc(lo(d3), (x6 << 1) | (x5 >> 31));
    t[7] = addc(hi(d3), x6 >> 31);
    return fe_redc(t);
}

// Montgomery form -> plain residue: REDC of (a, 0), i.e. a * 2^-128 mod p,
// the Montgomery product by 1 (field_ops.from_mont).  fe_mul's reduction
// steps with no partial products: word i of b = (1, 0, 0, 0) adds a to
// t = 0 in step 0 and nothing after.  Canonical for any a < 2^128.
__device__ __forceinline__ Fe fe_from_mont(const Fe& a) {
    uint32_t t0 = a.w[0], t1 = a.w[1], t2 = a.w[2], t3 = a.w[3], t4 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t m = 0u - t0;
        uint64_t s = static_cast<uint64_t>(t0) + m;
        s = static_cast<uint64_t>(t1) + (s >> 32);                        const uint32_t u0 = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(t2) + (s >> 32);                        const uint32_t u1 = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(m) * kPTop + t3 + (s >> 32);            const uint32_t u2 = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(t4) + (s >> 32);                        const uint32_t u3 = static_cast<uint32_t>(s);
        t4 = static_cast<uint32_t>(s >> 32);
        t0 = u0; t1 = u1; t2 = u2; t3 = u3;
    }
    return fe_reduce_once(t0, t1, t2, t3, t4);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
    uint64_t s;
    s = static_cast<uint64_t>(a.w[0]) + b.w[0];             const uint32_t t0 = static_cast<uint32_t>(s);
    s = static_cast<uint64_t>(a.w[1]) + b.w[1] + (s >> 32); const uint32_t t1 = static_cast<uint32_t>(s);
    s = static_cast<uint64_t>(a.w[2]) + b.w[2] + (s >> 32); const uint32_t t2 = static_cast<uint32_t>(s);
    s = static_cast<uint64_t>(a.w[3]) + b.w[3] + (s >> 32); const uint32_t t3 = static_cast<uint32_t>(s);
    return fe_reduce_once(t0, t1, t2, t3, static_cast<uint32_t>(s >> 32));
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
    Fe d;
    uint32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint64_t need = static_cast<uint64_t>(b.w[k]) + borrow;
        d.w[k] = static_cast<uint32_t>(static_cast<uint64_t>(a.w[k]) - need);
        borrow = static_cast<uint64_t>(a.w[k]) < need;
    }
    if (borrow) {  // a < b: add p back (mod 2^128)
        uint64_t s;
        s = static_cast<uint64_t>(d.w[0]) + 1u;                d.w[0] = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(d.w[1]) + (s >> 32);         d.w[1] = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(d.w[2]) + (s >> 32);         d.w[2] = static_cast<uint32_t>(s);
        s = static_cast<uint64_t>(d.w[3]) + kPTop + (s >> 32); d.w[3] = static_cast<uint32_t>(s);
    }
    return d;
}

}  // namespace stark
