// The JAX package's TPU timing probes B1-B4 (benches/) as Hopper kernels.
//
// Each Pallas probe times one piece of the prover's arithmetic alone; these
// kernels compute what each of them computes, so that the card measures
// the same pieces:
//
// * B1 probe_mont13_chain replaces the kernel of
//   benches/lazy_limb_experiment.py:144 (body mont_mul13, :68): 10 chained
//   Montgomery products a * t * 2^-130 mod p on 10 limbs of 13 bits, the
//   column sums taken lazily (a 26-bit partial fits a 32-bit column ten
//   times over) and one carry sweep at the end;
// * B2 probe_mont_chain replaces mont_mul_microbench's kernel,
//   benches/quick_pallas_timing.py:64: 10 chained production products,
//   here stark::fe_mul (field.cuh), the port's counterpart of
//   stark_tpu/ops/pallas_fold.py _k_mont_mul (4 x 32-bit words, 64-bit
//   partial products);
// * B3 probe_mont16_chain<Mode> replaces benches/mont_mul_experiments.py:115
//   (body _mont_mul_variant, :36): the TPU's 16-bit-limb CIOS as written
//   there, in mode base (the production product), hint16 (every operand
//   masked to 16 bits) or xor (every product an XOR: the floor of the
//   non-multiply work; no field meaning, but a fixed output);
// * B4 probe_level_stub and stark_probe_level_rounds replace
//   benches/merkle_roofline.py:97 (_call_level_variant, :89; bodies
//   _stub_kernel :57 and _rounds_kernel :64): the level kernel's grid with
//   an XOR of the two children's words, the launch and I/O floor, or the
//   level kernel itself (blake2b.cuh level_kernel<R>) with its compress
//   cut to R = 1 or 6 rounds; at R = 12 the probe runs K5,
//   stark_merkle_level.
//
// Layouts are the probes': x is (L, rows, cols) limb planes in an int32
// tensor and t is (L, rows, t_cols), reused for every block of t_cols
// columns as the Pallas t_spec's index map (0, 0, 0) reuses it: element
// (r, c) takes t's column c mod t_cols (t_cols a power of two).  t's limbs
// are drawn over their full width, so t may be >= p; with a < p and t below
// 2^(limbs x bits) each CIOS sum stays below 2p before its one subtraction.
//
// Design: one element (or parent) a thread, limbs in registers, no shared
// memory; a row of x is a row of the grid (blockIdx.y), so no thread
// divides.  The 10 products are unrolled, so each kernel is straight-line
// code and chip_smoke.py bounds it by its own SASS (ops/sass.py
// straight_line) times its warps.  At 2^20 elements B1-B3 are bound by
// operations (10 products against 64-80 bytes an element), the stub by
// bytes (48 a parent) and the round kernels, like the level kernel, by
// their 64-bit integer work.

#include <cuda_runtime.h>

#include <cstdint>

#include "blake2b.cuh"
#include "field.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMuls = 10;  // chained products a launch: the probes' N_MULS

// -- B1: 13-bit lazy limbs (R' = 2^130) ----------------------------------------

constexpr int kL13 = 10;
constexpr uint32_t kMask13 = (1u << 13) - 1;
constexpr uint32_t kPLimb9 = 1628;  // p = 1 + 1628 * 2^(13 * 9): limbs {0: 1, 9: 1628}

// a <- a * b * 2^-130 mod p; the column sums stay below 2^31
__device__ __forceinline__ void mont_mul13(uint32_t (&a)[kL13], const uint32_t (&b)[kL13]) {
    uint32_t t[kL13 + 1];
#pragma unroll
    for (int j = 0; j <= kL13; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < kL13; ++i) {
        const uint32_t bi = b[i];
#pragma unroll
        for (int j = 0; j < kL13; ++j) t[j] += a[j] * bi;  // full 26-bit partials, no split
        const uint32_t m = (0u - t[0]) & kMask13;           // p == 1 (mod 2^13)
        t[0] += m;
        t[9] += m * kPLimb9;  // p's only other limb
        const uint32_t carry = t[0] >> 13;
#pragma unroll
        for (int j = 0; j < kL13; ++j) t[j] = t[j + 1];
        t[kL13] = 0;
        t[0] += carry;
    }
    uint32_t out[kL13 + 2];  // one carry sweep to 13-bit limbs
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k <= kL13; ++k) {
        const uint32_t s = t[k] + carry;
        out[k] = s & kMask13;
        carry = s >> 13;
    }
    out[kL13 + 1] = carry;
    uint32_t diff[kL13];  // minus p, kept where no borrow leaves the top
    uint32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < kL13 + 2; ++k) {
        const uint32_t need = (k == 0 ? 1u : k == 9 ? kPLimb9 : 0u) + borrow;
        const uint32_t below = out[k] < need;
        if (k < kL13) diff[k] = (out[k] - need) & kMask13;
        borrow = below;
    }
#pragma unroll
    for (int k = 0; k < kL13; ++k) a[k] = borrow == 0 ? diff[k] : out[k];
}

// -- B3: the TPU's 16-bit CIOS --------------------------------------------------

constexpr int kBase = 0, kHint16 = 1, kXor = 2;
constexpr uint32_t kMask16 = 0xFFFFu;
constexpr uint32_t kPTop16 = stark::kPTop >> 16;  // limb 7 of p; limbs 1-6 are 0, limb 0 is 1

template <int Mode>
__device__ __forceinline__ uint32_t limb_product(uint32_t a, uint32_t b) {
    if constexpr (Mode == kXor) {
        return a ^ b;
    } else if constexpr (Mode == kHint16) {
        return (a & kMask16) * (b & kMask16);
    } else {
        return a * b;
    }
}

// a <- _mont_mul_variant(a, b, Mode): uint32 throughout, as on the TPU
template <int Mode>
__device__ __forceinline__ void mont_mul16(uint32_t (&a)[8], const uint32_t (&b)[8]) {
    uint32_t t[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const uint32_t bi = b[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const uint32_t prod = limb_product<Mode>(a[j], bi);
            t[j] += prod & kMask16;
            t[j + 1] += prod >> 16;
        }
        const uint32_t m = (0u - t[0]) & kMask16;
        const uint32_t t0 = t[0] + m;
        uint32_t mp;
        if constexpr (Mode == kXor) {
            mp = m ^ kPTop16;
        } else if constexpr (Mode == kHint16) {
            mp = (m & kMask16) * kPTop16;
        } else {
            mp = m * kPTop16;
        }
        t[7] += mp & kMask16;
        t[8] += mp >> 16;
        const uint32_t carry = t0 >> 16;
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = t[j + 1];
        t[8] = 0;
        t[0] += carry;
    }
    uint32_t out[9];  // carry sweep over the nine limbs, the last carry dropped
    uint32_t carry = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const uint32_t s = t[k] + carry;
        out[k] = s & kMask16;
        carry = s >> 16;
    }
    uint32_t diff[8];
    uint32_t borrow = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const uint32_t need = (k == 0 ? 1u : k == 7 ? kPTop16 : 0u) + borrow;
        const uint32_t below = out[k] < need;
        if (k < 8) diff[k] = (out[k] - need) & kMask16;
        borrow = below;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = borrow == 0 ? diff[k] : out[k];
}

// -- the chain kernels: element (blockIdx.y, c), t at column c mod t_cols --------

struct ChainIndex {
    int64_t plane, t_plane, e, te;
};

__device__ __forceinline__ ChainIndex chain_index(int c, int cols, int t_cols) {
    const int64_t rows = gridDim.y, r = blockIdx.y;
    return {rows * cols, rows * t_cols, r * cols + c, r * t_cols + (c & (t_cols - 1))};
}

__global__ void __launch_bounds__(kThreads)
    probe_mont13_chain(const uint32_t* __restrict__ x, const uint32_t* __restrict__ t, uint32_t* __restrict__ out,
                       int cols, int t_cols) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= cols) return;
    const ChainIndex at = chain_index(c, cols, t_cols);
    uint32_t a[kL13], b[kL13];
#pragma unroll
    for (int l = 0; l < kL13; ++l) {
        a[l] = x[l * at.plane + at.e];
        b[l] = t[l * at.t_plane + at.te];
    }
#pragma unroll
    for (int k = 0; k < kMuls; ++k) mont_mul13(a, b);
#pragma unroll
    for (int l = 0; l < kL13; ++l) out[l * at.plane + at.e] = a[l];
}

__global__ void __launch_bounds__(kThreads)
    probe_mont_chain(const int32_t* __restrict__ x, const int32_t* __restrict__ t, int32_t* __restrict__ out,
                     int cols, int t_cols) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= cols) return;
    const ChainIndex at = chain_index(c, cols, t_cols);
    stark::Fe a = stark::fe_load(x, at.plane, at.e);
    const stark::Fe b = stark::fe_load(t, at.t_plane, at.te);
#pragma unroll
    for (int k = 0; k < kMuls; ++k) a = stark::fe_mul(a, b);
    stark::fe_store(out, at.plane, at.e, a);
}

template <int Mode>
__global__ void __launch_bounds__(kThreads)
    probe_mont16_chain(const uint32_t* __restrict__ x, const uint32_t* __restrict__ t, uint32_t* __restrict__ out,
                       int cols, int t_cols) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= cols) return;
    const ChainIndex at = chain_index(c, cols, t_cols);
    uint32_t a[8], b[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
        a[l] = x[l * at.plane + at.e];
        b[l] = t[l * at.t_plane + at.te];
    }
#pragma unroll
    for (int k = 0; k < kMuls; ++k) mont_mul16<Mode>(a, b);
#pragma unroll
    for (int l = 0; l < 8; ++l) out[l * at.plane + at.e] = a[l];
}

// -- B4: the level kernel's grid, parent i of the (8, w) level -----------------

__global__ void __launch_bounds__(kThreads)
    probe_level_stub(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int64_t w) {
    const int64_t half = w / 2;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= half) return;
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k * half + i] = in[k * w + 2 * i] ^ in[k * w + 2 * i + 1];
}

// the chain probes' grid: a block of kThreads columns by a row of x
bool chain_grid(int64_t rows, int64_t cols, int64_t t_cols, dim3& grid) {
    if (rows < 1 || rows > 65535 || cols < 1 || cols > (int64_t{1} << 30) || t_cols < 1 ||
        t_cols > (int64_t{1} << 30) || (t_cols & (t_cols - 1)))
        return false;
    grid = dim3(static_cast<unsigned>((cols + kThreads - 1) / kThreads), static_cast<unsigned>(rows));
    return true;
}

}  // namespace

// x, out: (10, rows, cols) 13-bit limbs, x < p; t: (10, rows, t_cols).
extern "C" int stark_probe_mont13_chain(const int32_t* x, const int32_t* t, int32_t* out, int64_t rows, int64_t cols,
                                        int64_t t_cols, void* stream) {
    dim3 grid;
    if (!chain_grid(rows, cols, t_cols, grid)) return cudaErrorInvalidValue;
    probe_mont13_chain<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(x), reinterpret_cast<const uint32_t*>(t), reinterpret_cast<uint32_t*>(out),
        static_cast<int>(cols), static_cast<int>(t_cols));
    return cudaGetLastError();
}

// x, out: (8, rows, cols) 16-bit limbs, x < p; t: (8, rows, t_cols).
extern "C" int stark_probe_mont_chain(const int32_t* x, const int32_t* t, int32_t* out, int64_t rows, int64_t cols,
                                      int64_t t_cols, void* stream) {
    dim3 grid;
    if (!chain_grid(rows, cols, t_cols, grid)) return cudaErrorInvalidValue;
    probe_mont_chain<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, t, out, static_cast<int>(cols),
                                                                              static_cast<int>(t_cols));
    return cudaGetLastError();
}

// as stark_probe_mont_chain; mode 0 = base, 1 = hint16, 2 = xor.
extern "C" int stark_probe_mont16_chain(const int32_t* x, const int32_t* t, int32_t* out, int64_t rows, int64_t cols,
                                        int64_t t_cols, int mode, void* stream) {
    dim3 grid;
    if (!chain_grid(rows, cols, t_cols, grid)) return cudaErrorInvalidValue;
    const auto* xu = reinterpret_cast<const uint32_t*>(x);
    const auto* tu = reinterpret_cast<const uint32_t*>(t);
    auto* ou = reinterpret_cast<uint32_t*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    const int c = static_cast<int>(cols), tc = static_cast<int>(t_cols);
    switch (mode) {
        case kBase: probe_mont16_chain<kBase><<<grid, kThreads, 0, s>>>(xu, tu, ou, c, tc); break;
        case kHint16: probe_mont16_chain<kHint16><<<grid, kThreads, 0, s>>>(xu, tu, ou, c, tc); break;
        case kXor: probe_mont16_chain<kXor><<<grid, kThreads, 0, s>>>(xu, tu, ou, c, tc); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// level: (8, w) with w even; out: (8, w / 2).
extern "C" int stark_probe_level_stub(const int32_t* level, int32_t* out, int64_t w, void* stream) {
    if (w < 2 || w % 2) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((w / 2 + kThreads - 1) / kThreads);
    probe_level_stub<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint32_t*>(level), reinterpret_cast<uint32_t*>(out), w);
    return cudaGetLastError();
}

// as stark_probe_level_stub; rounds 1 or 6 (12 is stark_merkle_level).
extern "C" int stark_probe_level_rounds(const int32_t* level, int32_t* out, int64_t w, int rounds, void* stream) {
    if (w < 2 || w % 2) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>((w / 2 + kThreads - 1) / kThreads);
    const auto* in = reinterpret_cast<const uint32_t*>(level);
    auto* o = reinterpret_cast<uint32_t*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    switch (rounds) {
        case 1: stark::level_kernel<1><<<blocks, kThreads, 0, s>>>(in, o, w); break;
        case 6: stark::level_kernel<6><<<blocks, kThreads, 0, s>>>(in, o, w); break;
        default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// The launch floor: a kernel that does nothing, one warp.  It replaces no
// TPU kernel; chip_smoke.py times it (ops/timing.launch_floor_ms) as the
// least a launch takes on the card, beside the kernels bound by their
// latency (merkle_top, fs_round, the opening gathers).
__global__ void empty_kernel() {}

extern "C" int stark_launch_floor(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return cudaGetLastError();
}
