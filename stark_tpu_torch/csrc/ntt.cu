// Four-step NTT passes (K2 and K3) for Hopper.
//
// Replaces the two Pallas passes of stark_tpu/ops/pallas_ntt.py
// (PallasNTT._pass1 and PallasNTT._pass2).  n = R * C; the data are
// (8, R, C) tensors of 16-bit Montgomery limbs.
//
//   pass 1: column NTTs of size R over x[j1, j2] (rows bit-reversed on
//           load), optional coset prologue x *= row[j1'] * col[j2]
//           (j1' the bit-reversed storage row), epilogue *= W[k1, j2].
//   pass 2: row NTTs of size C over pass 1's output read transposed
//           (element [j2, k1] = A[k1, j2]), optional epilogue
//           *= row[k2] * col[k1] (1/n and the coset undo of inverse
//           transforms); written as (8, C, R), i.e. natural order
//           k = k1 + R * k2.
//
// The TPU version runs the bit-reversal gathers and the transpose in XLA
// between the passes; here they are folded into the loads and stores.
//
// Design: one block per tile of `tile` adjacent batch columns; the tile's
// transforms live in shared memory as 16-byte elements (L * tile * 16 B,
// at most 128 KB) with the stage twiddles beside them, so a pass reads
// and writes device memory once.  At n = 2^20 a pass moves 64 to 96 MB
// (about 20 to 30 us at the card's bandwidth) and runs 5 * 2^19
// butterflies of one Montgomery multiply each (about 20 us of integer
// issue); it measures about 0.15 ms (PERF.md), so neither bound is
// reached: one 512-thread block per SM (128 KB of shared memory) leaves
// 16 warps to hide shared-memory and barrier latency over log2(L)
// stages.  Smaller tiles with more blocks per SM, register-resident
// early stages, wgmma or TMA are later work.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using stark::Fe;

constexpr int kThreads = 512;
constexpr int kMaxTileElems = 8192;  // L * tile: 128 KB of shared data
constexpr int kMaxLogL = 12;

__global__ void ntt_pass_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                int log_l, int batch, int tile,
                                int64_t in_sr, int64_t in_sc, int64_t out_sr, int64_t out_sc,
                                const int32_t* __restrict__ tw, const int32_t* __restrict__ w,
                                const int32_t* __restrict__ row, const int32_t* __restrict__ col,
                                int row_col_before) {
    extern __shared__ Fe smem[];
    const int L = 1 << log_l;
    const int64_t plane = static_cast<int64_t>(L) * batch;
    Fe* data = smem;                                  // data[r * tile + c]
    Fe* tws = smem + static_cast<int64_t>(L) * tile;  // stage with half h at [h, 2h)
    const int64_t c0 = static_cast<int64_t>(blockIdx.x) * tile;
    const int total = L * tile;

    for (int i = threadIdx.x; i < L; i += blockDim.x) tws[i] = stark::fe_load(tw, L, i);

    // load: consecutive threads walk the contiguous axis of the input
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        int r, c;
        if (in_sc == 1) { r = idx / tile; c = idx % tile; }
        else            { c = idx / L;    r = idx % L; }
        const int rr = static_cast<int>(__brev(static_cast<unsigned>(r)) >> (32 - log_l));
        Fe x = stark::fe_load(in, plane, r * in_sr + (c0 + c) * in_sc);
        if (row != nullptr && row_col_before) {
            x = stark::fe_mul(stark::fe_mul(x, stark::fe_load(row, L, rr)),
                              stark::fe_load(col, batch, c0 + c));
        }
        data[rr * tile + c] = x;
    }
    __syncthreads();

    // radix-2 decimation-in-time stages on bit-reversed input
    for (int half = 1; half < L; half <<= 1) {
        for (int idx = threadIdx.x; idx < (L / 2) * tile; idx += blockDim.x) {
            const int c = idx % tile;
            const int k = idx / tile;
            const int j = k & (half - 1);
            const int i0 = 2 * k - j;
            const int i1 = i0 + half;
            const Fe u = data[i0 * tile + c];
            const Fe v = stark::fe_mul(data[i1 * tile + c], tws[half + j]);
            data[i0 * tile + c] = stark::fe_add(u, v);
            data[i1 * tile + c] = stark::fe_sub(u, v);
        }
        __syncthreads();
    }

    // epilogue + store: consecutive threads walk the contiguous axis of the output
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        int r, c;
        if (out_sc == 1) { r = idx / tile; c = idx % tile; }
        else             { c = idx / L;    r = idx % L; }
        const int64_t off = r * out_sr + (c0 + c) * out_sc;
        Fe x = data[r * tile + c];
        if (w != nullptr) x = stark::fe_mul(x, stark::fe_load(w, plane, off));
        if (row != nullptr && !row_col_before) {
            x = stark::fe_mul(stark::fe_mul(x, stark::fe_load(row, L, r)),
                              stark::fe_load(col, batch, c0 + c));
        }
        stark::fe_store(out, plane, off, x);
    }
}

int launch_pass(const int32_t* in, int32_t* out, int log_l, int log_b,
                int64_t in_sr, int64_t in_sc, int64_t out_sr, int64_t out_sc,
                const int32_t* tw, const int32_t* w, const int32_t* row, const int32_t* col,
                int row_col_before, cudaStream_t stream) {
    if (log_l < 1 || log_l > kMaxLogL || log_b < 0 || log_b > 20) return cudaErrorInvalidValue;
    const int L = 1 << log_l;
    const int batch = 1 << log_b;
    int tile = kMaxTileElems / L;
    if (tile > 32) tile = 32;
    if (tile > batch) tile = batch;
    const size_t smem = (static_cast<size_t>(L) * tile + L) * sizeof(Fe);
    cudaError_t err = cudaFuncSetAttribute(ntt_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    ntt_pass_kernel<<<batch / tile, kThreads, smem, stream>>>(
        in, out, log_l, batch, tile, in_sr, in_sc, out_sr, out_sc, tw, w, row, col, row_col_before);
    return cudaGetLastError();
}

}  // namespace

// x, out: (8, R, C); tw: (8, R) packed stage twiddles; w: (8, R, C);
// row: (8, R) in bit-reversed order and col: (8, C), both null for no prologue.
extern "C" int stark_ntt_pass1(const int32_t* x, int32_t* out, int log_r, int log_c,
                               const int32_t* tw, const int32_t* w,
                               const int32_t* row, const int32_t* col, void* stream) {
    const int64_t C = int64_t{1} << log_c;
    return launch_pass(x, out, log_r, log_c, /*in*/ C, 1, /*out*/ C, 1, tw, w, row, col, 1,
                       static_cast<cudaStream_t>(stream));
}

// y: (8, R, C) pass-1 output; out: (8, C, R); tw: (8, C);
// row: (8, C) and col: (8, R), both null for no epilogue.
extern "C" int stark_ntt_pass2(const int32_t* y, int32_t* out, int log_r, int log_c,
                               const int32_t* tw, const int32_t* row, const int32_t* col, void* stream) {
    const int64_t C = int64_t{1} << log_c;
    const int64_t R = int64_t{1} << log_r;
    return launch_pass(y, out, log_c, log_r, /*in*/ 1, C, /*out*/ R, 1, tw, nullptr, row, col, 0,
                       static_cast<cudaStream_t>(stream));
}
