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
// Bound: at n = 2^20 a pass moves 64 to 96 MB (20 to 30 us at 3.35
// TB/s) and issues 51 / 45 million warp instructions (chip_smoke.py
// counts each loop body in this library's SASS, ops/sass.py: ~750
// instructions a thread for a radix-4 butterfly, 210 to 380 for a loaded
// or stored element with its products), 0.049 / 0.043 ms at 4 a clock
// per SM on 132 SMs at 1.98 GHz, so both passes are bound by issue.
//
// Design: one block per transform (one batch column), so a pass launches
// one block per column, >= 256 from 2^17 up; the transform lives in
// shared memory as 16-byte elements, so a pass reads and writes device
// memory once.  L / 2 threads, 256 at most (cuda_ntt.launch_shape),
// capped at 64 registers (__launch_bounds__), so four blocks fit on an
// SM: 32 warps at 2^20.  Each step between barriers is a radix-4
// butterfly (two radix-2 stages) in registers: ceil(log2(L) / 2)
// barriers instead of log2(L), with the same twiddles and the same
// Montgomery products in the same order, so every number is unchanged.
// The stage twiddles sit in shared memory where two blocks still fit on
// an SM (L <= 2048) and are read through the read-only cache otherwise.
// A one-column block touches 4 bytes of each 32-byte sector along the
// column axis (pass 1's loads and stores, pass 2's transposed stores);
// so the blocks run in clusters of 8 (__cluster_dims__), and each block
// loads and stores a 1/8 share of the rows across the cluster's 8
// columns, one whole sector a row, exchanging the elements with their
// owners through distributed shared memory; on an H100 that is what let
// one-column blocks beat wider tiles at 2^20 (PERF.md).  chip_smoke.py
// prints the registers and resident blocks: 56 (pass 1) and 52 (pass 2)
// registers, no spills, 4 blocks an SM at 2^20, 9 for pass 1 at 2^17.
//
// The cluster's width is a template argument (kLogCluster, 0 to 3):
// cuda_ntt.launch_shape takes min(8, batch, L) blocks, so a shard of a
// sharded transform with fewer than 8 columns (or rows) runs in clusters
// of 4, 2 or 1, each block moving L / width rows of the cluster's
// columns.  Every one-device transform has 8 or more of each and runs
// the 8-wide instantiation.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

namespace cg = cooperative_groups;
using stark::Fe;

constexpr int kMaxThreads = 256;
constexpr int kMinBlocksPerSm = 4;  // 65536 registers / (4 * 256 threads) = 64 a thread
constexpr int kMaxLogL = 12;
constexpr int kMaxLogCluster = 3;   // 8 one-column blocks: 8 x 4 bytes, one sector a limb plane

// Pass 1 (kPass1) reads x[r, c] at r * batch + c and multiplies by the
// coset prologue (kRowCol) and by W; pass 2 reads y[c, r] at c * L + r
// and multiplies by the epilogue (kRowCol).  Both write out[r, c] at
// r * batch + c.  The choices are template arguments, so no loop of an
// instantiation branches on them, and no loop is unrolled: each body in
// the SASS is one iteration (chip_smoke.py counts them for the bound).
// A cluster holds 2^kLogCluster blocks.
template <bool kPass1, bool kTwShared, bool kRowCol, int kLogCluster>
__global__ void __cluster_dims__(1 << kLogCluster, 1, 1) __launch_bounds__(kMaxThreads, kMinBlocksPerSm)
ntt_pass_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out, int log_l, int batch,
                const int32_t* __restrict__ tw, const int32_t* __restrict__ w,
                const int32_t* __restrict__ row, const int32_t* __restrict__ col) {
    constexpr int kCluster = 1 << kLogCluster;
    extern __shared__ Fe smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int L = 1 << log_l;
    const int64_t plane = static_cast<int64_t>(L) * batch;
    Fe* data = smem;      // the block's transform, data[r]
    Fe* tws = smem + L;   // stage with half h at [h, 2h)
    const int64_t c0 = blockIdx.x;  // the block's column
    // Loads and stores along the column axis are shared by the cluster:
    // block `rank` moves rows [r0, r0 + L / kCluster) of all the cluster's
    // kCluster columns, one kCluster-element run a row, and its element of
    // column cc0 + k belongs to block k.
    const int rank = static_cast<int>(cluster.block_rank());
    const int64_t cc0 = c0 - rank;  // the cluster's first column
    const int r0 = rank << (log_l - kLogCluster);
    auto bitrev = [&](int r) { return static_cast<int>(__brev(static_cast<unsigned>(r)) >> (32 - log_l)); };

    // distributed shared memory may be written only once every block of
    // the cluster has started: arrive now, wait before the first write
    if constexpr (kPass1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    if constexpr (kTwShared) {
#pragma unroll 1
        for (int i = threadIdx.x; i < L; i += blockDim.x) tws[i] = stark::fe_load(tw, L, i);
    }
    auto twiddle = [&](int i) {
        if constexpr (kTwShared) return tws[i];
        else return stark::fe_load(tw, L, i);
    };

    // load: consecutive threads walk the contiguous axis of the input
    if constexpr (kPass1) {  // along the columns: the cluster's rows share
        asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
#pragma unroll 1
        for (int idx = threadIdx.x; idx < L; idx += blockDim.x) {
            const int r = r0 + (idx >> kLogCluster);
            const int k = idx & (kCluster - 1);
            const int rr = bitrev(r);
            Fe x = stark::fe_load(in, plane, static_cast<int64_t>(r) * batch + cc0 + k);
            if constexpr (kRowCol) {
                x = stark::fe_mul(stark::fe_mul(x, stark::fe_load(row, L, rr)), stark::fe_load(col, batch, cc0 + k));
            }
            cluster.map_shared_rank(data, k)[rr] = x;
        }
        cluster.sync();
    } else {  // along the rows: the block's own column
#pragma unroll 1
        for (int r = threadIdx.x; r < L; r += blockDim.x) data[bitrev(r)] = stark::fe_load(in, plane, c0 * L + r);
        __syncthreads();
    }

    // decimation-in-time stages on bit-reversed input, two radix-2 stages
    // (halves h and 2h) per radix-4 step, in registers between barriers
    int half = 1;
    for (; 4 * half <= L; half *= 4) {
#pragma unroll 1
        for (int k = threadIdx.x; k < L / 4; k += blockDim.x) {
            const int j = k & (half - 1);
            Fe* p = data + 4 * k - 3 * j;  // group of 4h at 4(k - j), offset j
            const Fe a0 = p[0], a1 = p[half], a2 = p[2 * half], a3 = p[3 * half];
            const Fe t1 = twiddle(half + j);
            const Fe v1 = stark::fe_mul(a1, t1);
            const Fe v3 = stark::fe_mul(a3, t1);
            const Fe b0 = stark::fe_add(a0, v1), b1 = stark::fe_sub(a0, v1);
            const Fe b2 = stark::fe_add(a2, v3), b3 = stark::fe_sub(a2, v3);
            const Fe v2 = stark::fe_mul(b2, twiddle(2 * half + j));
            const Fe v4 = stark::fe_mul(b3, twiddle(3 * half + j));
            p[0] = stark::fe_add(b0, v2);
            p[2 * half] = stark::fe_sub(b0, v2);
            p[half] = stark::fe_add(b1, v4);
            p[3 * half] = stark::fe_sub(b1, v4);
        }
        __syncthreads();
    }
    if (half < L) {  // odd log2(L): one radix-2 stage with half L / 2 ends it
#pragma unroll 1
        for (int j = threadIdx.x; j < L / 2; j += blockDim.x) {
            const Fe u = data[j];
            const Fe v = stark::fe_mul(data[half + j], twiddle(half + j));
            data[j] = stark::fe_add(u, v);
            data[half + j] = stark::fe_sub(u, v);
        }
        __syncthreads();
    }

    // epilogue + store along the columns, the cluster's rows shared
    cluster.sync();  // every block of the cluster has its transform done
#pragma unroll 1
    for (int idx = threadIdx.x; idx < L; idx += blockDim.x) {
        const int r = r0 + (idx >> kLogCluster);
        const int k = idx & (kCluster - 1);
        const int64_t off = static_cast<int64_t>(r) * batch + cc0 + k;
        Fe x = cluster.map_shared_rank(data, k)[r];
        if constexpr (kPass1) {
            x = stark::fe_mul(x, stark::fe_load(w, plane, off));
        } else if constexpr (kRowCol) {
            x = stark::fe_mul(stark::fe_mul(x, stark::fe_load(row, L, r)), stark::fe_load(col, batch, cc0 + k));
        }
        stark::fe_store(out, plane, off, x);
    }
    cluster.sync();  // no block leaves while another reads its shared memory
}

using PassKernel = void (*)(const int32_t*, int32_t*, int, int, const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*);

template <bool kPass1, int kLogCluster>
PassKernel pass_kernel_of_width(bool tw_shared, bool row_col) {
    if (tw_shared) {
        return row_col ? ntt_pass_kernel<kPass1, true, true, kLogCluster>
                       : ntt_pass_kernel<kPass1, true, false, kLogCluster>;
    }
    return row_col ? ntt_pass_kernel<kPass1, false, true, kLogCluster>
                   : ntt_pass_kernel<kPass1, false, false, kLogCluster>;
}

template <bool kPass1>
PassKernel pass_kernel(bool tw_shared, bool row_col, int log_cluster) {
    switch (log_cluster) {
        case 0: return pass_kernel_of_width<kPass1, 0>(tw_shared, row_col);
        case 1: return pass_kernel_of_width<kPass1, 1>(tw_shared, row_col);
        case 2: return pass_kernel_of_width<kPass1, 2>(tw_shared, row_col);
        default: return pass_kernel_of_width<kPass1, kMaxLogCluster>(tw_shared, row_col);
    }
}

// Checks the launch shape the host chose (cuda_ntt.launch_shape): a
// cluster of 2^log_cluster columns, at most 8 and no more than the
// columns or the rows (a block moves L / 2^log_cluster rows), a transform
// of at least 2 points, a block of whole warps within the kernel's bound,
// and shared memory for the transform with or without the L stage
// twiddles; sets *tw_shared.
cudaError_t check_shape(int log_l, int log_b, int log_cluster, int threads, int smem, bool* tw_shared) {
    if (log_l < 1 || log_l > kMaxLogL || log_b < 0 || log_b > 20) return cudaErrorInvalidValue;
    if (log_cluster < 0 || log_cluster > kMaxLogCluster || log_cluster > log_b || log_cluster > log_l) {
        return cudaErrorInvalidValue;
    }
    if (threads < 32 || threads > kMaxThreads || threads % 32 != 0) return cudaErrorInvalidValue;
    const int64_t data_bytes = (int64_t{1} << log_l) * static_cast<int64_t>(sizeof(Fe));
    if (smem == data_bytes) *tw_shared = false;
    else if (smem == 2 * data_bytes) *tw_shared = true;
    else return cudaErrorInvalidValue;
    return cudaSuccess;
}

template <bool kPass1>
int launch_pass(const int32_t* in, int32_t* out, int log_l, int log_b, const int32_t* tw, const int32_t* w,
                const int32_t* row, const int32_t* col, int threads, int smem, int log_cluster,
                cudaStream_t stream) {
    bool tw_shared;
    cudaError_t err = check_shape(log_l, log_b, log_cluster, threads, smem, &tw_shared);
    if (err != cudaSuccess) return err;
    const PassKernel kernel = pass_kernel<kPass1>(tw_shared, row != nullptr, log_cluster);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<1u << log_b, threads, smem, stream>>>(in, out, log_l, 1 << log_b, tw, w, row, col);
    return cudaGetLastError();
}

}  // namespace

// x, out: (8, R, C); tw: (8, R) packed stage twiddles; w: (8, R, C);
// row: (8, R) in bit-reversed order and col: (8, C), both null for no
// prologue; threads, smem, log_cluster: cuda_ntt.launch_shape(log_r, log_c).
extern "C" int stark_ntt_pass1(const int32_t* x, int32_t* out, int log_r, int log_c,
                               const int32_t* tw, const int32_t* w,
                               const int32_t* row, const int32_t* col,
                               int threads, int smem, int log_cluster, void* stream) {
    if (w == nullptr || (row == nullptr) != (col == nullptr)) return cudaErrorInvalidValue;
    return launch_pass<true>(x, out, log_r, log_c, tw, w, row, col, threads, smem, log_cluster,
                             static_cast<cudaStream_t>(stream));
}

// y: (8, R, C) pass-1 output; out: (8, C, R); tw: (8, C);
// row: (8, C) and col: (8, R), both null for no epilogue;
// threads, smem, log_cluster: cuda_ntt.launch_shape(log_c, log_r).
extern "C" int stark_ntt_pass2(const int32_t* y, int32_t* out, int log_r, int log_c,
                               const int32_t* tw, const int32_t* row, const int32_t* col,
                               int threads, int smem, int log_cluster, void* stream) {
    if ((row == nullptr) != (col == nullptr)) return cudaErrorInvalidValue;
    return launch_pass<false>(y, out, log_c, log_r, tw, nullptr, row, col, threads, smem, log_cluster,
                              static_cast<cudaStream_t>(stream));
}

// What the card makes of one pass's launch shape, for the 8-wide
// instantiation with row/col multipliers (the prover's coset extension in
// pass 1, its inverse in pass 2): the kernel's registers a thread and
// local (spill) bytes, how many of its blocks of `threads` threads with `smem` bytes
// of shared memory an SM holds at once, and how many of its clusters the
// card holds at once.
extern "C" int stark_ntt_occupancy(int pass1, int log_l, int threads, int smem, int* registers, int* local_bytes,
                                   int* blocks_per_sm, int* active_clusters) {
    bool tw_shared;
    cudaError_t err = check_shape(log_l, kMaxLogCluster, kMaxLogCluster, threads, smem, &tw_shared);
    if (err != cudaSuccess) return err;
    const PassKernel kernel = pass1 ? pass_kernel<true>(tw_shared, true, kMaxLogCluster)
                                    : pass_kernel<false>(tw_shared, true, kMaxLogCluster);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    *registers = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((1 << kMaxLogCluster) * 1024, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    return cudaOccupancyMaxActiveClusters(active_clusters, kernel, &cfg);
}
