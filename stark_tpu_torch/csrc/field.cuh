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
