// FRI fold (K6) for Hopper.
//
// Replaces the Pallas kernel of stark_tpu/ops/pallas_fold.py
// (fold_mont_pallas / _fold_kernel):
//
//     out[i] = 1/2 [ (1 + a*inv_i) u_i + (1 - a*inv_i) v_i ],
//     u = codeword[:, :n/2], v = codeword[:, n/2:], all Montgomery form.
//
// Design: one thread per output element, with the field helpers of
// field.cuh (four Montgomery products, two additions, one subtraction).
// Per output the kernel reads three elements (u_i, v_i, inv_i: 96 bytes)
// and writes one (32 bytes), against ~350 32-bit integer operations
// (counted as in chip_smoke.py), so it is bound by memory: at 2^19 outputs
// it moves 64 MiB, 0.020 ms at the 3.35 TB/s of an H100 SXM at its 700 W
// limit, while the integer work needs about half that.  The 16-bit limb
// planes are read with neighbouring threads on neighbouring addresses, so
// every load and store is coalesced.  alpha arrives as an (8, 1)
// Montgomery column on the device, so the fold can follow a device
// Fiat-Shamir draw (fs.cu) without a host round trip.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kThreads = 256;

using stark::Fe;

// R mod p (Montgomery one) and 2^-1 * R mod p, as four 32-bit words.
__device__ __forceinline__ Fe mont_one() { return Fe{{0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x347FFFFFu}}; }
__device__ __forceinline__ Fe mont_half() { return Fe{{0x00000000u, 0x00000000u, 0x00000000u, 0x80000000u}}; }

__global__ void fold_kernel(const int32_t* __restrict__ cw, const int32_t* __restrict__ inv,
                            const int32_t* __restrict__ alpha, int32_t* __restrict__ out, int64_t half) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= half) return;
    const int64_t n = 2 * half;
    const Fe u = stark::fe_load(cw, n, i);
    const Fe v = stark::fe_load(cw, n, half + i);
    const Fe t = stark::fe_load(inv, half, i);
    const Fe a = stark::fe_load(alpha, 1, 0);
    const Fe one = mont_one();
    const Fe ai = stark::fe_mul(a, t);
    const Fe left = stark::fe_mul(stark::fe_add(one, ai), u);
    const Fe right = stark::fe_mul(stark::fe_sub(one, ai), v);
    stark::fe_store(out, half, i, stark::fe_mul(mont_half(), stark::fe_add(left, right)));
}

}  // namespace

// codeword: (8, 2 * half) Montgomery limbs; inv: (8, half); alpha: (8, 1);
// out: (8, half).
extern "C" int stark_fri_fold(const int32_t* codeword, const int32_t* inv, const int32_t* alpha, int32_t* out,
                              int64_t half, void* stream) {
    if (half <= 0) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((half + kThreads - 1) / kThreads);
    fold_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(codeword, inv, alpha, out, half);
    return cudaGetLastError();
}
