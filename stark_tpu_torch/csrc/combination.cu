// The combination (K11) for Hopper: AIR evaluation, transition quotients and
// the weighted sum of a prove in one pass over the points.
//
// In the JAX package this is one jitted XLA executable, which its docstring
// calls "the combination megakernel" (stark_tpu/ops/device_prover.py
// DeviceProverCore.combination_fn, jitted at :695); it is not a Pallas
// kernel.  Per point i of the n-point FRI domain it computes
//
//   state   = trace columns at i, then the same columns at the next row,
//             i + expansion (mod n)
//   air_c   = sum over constraint c's groups of group_cw[g] * prod_j state_j^e_j
//   tq_c    = air_c * tz_inv_c
//   comb    = w_0 * rand + sum_c (w * tq_c + w' * shift_c * tq_c)
//                        + sum_b (w * bq_b + w' * bq_shift_b * bq_b)
//
// and writes comb and every tq_c (the degree probe reads them).
//
// The next-row operand: a prover that splits the domain over shards (the
// sharded core, stark_tpu_torch/parallel/stark_sharded.py) keeps a shard's
// points in the four-step layout, where the point expansion steps on can
// lie in another shard.  It passes, per trace column, the shard's next
// rows as a codeword of their own (next[j][i] = trace column j at the
// point after i), built by slices and copies; the kernel then reads the
// next row at i from those planes.  It is an instantiation of its own
// (kNextRows), so the one-device kernel's code is unchanged.
//
// The AIR's shape arrives as a program (ops/cuda_combination.py encodes it
// on the host once a structure): the powers to build, each a state column
// loaded or the square of an earlier power times the column where its
// exponent is odd; each constraint's groups as a group codeword and up to
// kMaxFactors power slots.  The program, the codeword pointers and the
// weights pointer travel by value in one kernel parameter (CombParams,
// __grid_constant__, so indexing it reads the parameter bank and copies
// nothing to local memory); a prove uploads nothing for this kernel.
//
// Bound: every input codeword is read once and every output written once,
// 32 bytes an element: fib at 2^20 reads ~15 codewords and writes 3
// (~0.6 GB, ~0.18 ms at 3.35 TB/s), the Rescue chain ~40 and 5 (~1.5 GB,
// ~0.45 ms), against ~20 and ~70 field products a point (~0.09 and
// ~0.31 ms of issue).  So it is bound by bytes.  Design: one thread a
// point, limb planes read coalesced (field.cuh fe_load), the next row read
// at i + expansion from the same planes (no rolled copy), each power kept
// in shared memory at [slot][thread] (no local memory, no bank conflicts
// beyond the 16-byte element's), built once and read by every group that
// needs it.  No barriers: a thread touches only its own slots.

#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace stark {

// limits of one program; ops/cuda_combination.py keeps the same numbers
// and refuses a structure beyond them
constexpr int kMaxTrace = 8;         // trace columns (state: 2 x, this row and the next)
constexpr int kMaxPowers = 48;       // power slots, the loaded state columns among them
constexpr int kMaxConstraints = 8;   // transition constraints
constexpr int kMaxTerms = 64;        // (group, powers) terms over all constraints
constexpr int kMaxFactors = 4;       // power slots a term multiplies in
constexpr int kMaxGroups = 64;       // group codewords
constexpr int kMaxBq = 8;            // boundary quotients
constexpr int kThreads = 128;     // points a block

struct CombParams {
    const int32_t* trace[kMaxTrace];
    // all null, or all n_trace set: trace column j at the next row, at i
    const int32_t* next[kMaxTrace];
    const int32_t* groups[kMaxGroups];
    const int32_t* tz_inv[kMaxConstraints];
    const int32_t* tq_shift[kMaxConstraints];
    const int32_t* bq[kMaxBq];
    const int32_t* bq_shift[kMaxBq];
    const int32_t* rand;
    const int32_t* weights;  // (8, n_weights) Montgomery
    int32_t* comb;           // (8, n)
    int32_t* tqs;            // (n_constraints, 8, n)
    int64_t n;
    int64_t expansion;       // 0 <= expansion < n
    int32_t n_trace;
    int32_t n_weights;       // 1 + 2 * (n_constraints + n_bq)
    int32_t n_powers;
    int32_t n_constraints;
    int32_t n_bq;
    int32_t n_groups;
    // slot s: pow_base[s] < 0 loads state column pow_mul[s] (j < n_trace:
    // trace j at i; else trace j - n_trace at the next row); otherwise the
    // slot is slot pow_base[s] squared, times slot pow_mul[s] if >= 0
    int8_t pow_base[kMaxPowers];
    int8_t pow_mul[kMaxPowers];
    // term t: group codeword term_group[t] times the slots term_slots[t][f]
    // until the first negative one; constraint c's terms end at
    // constraint_end[c] (those of c - 1 where they begin)
    uint8_t term_group[kMaxTerms];
    int8_t term_slots[kMaxTerms][kMaxFactors];
    uint8_t constraint_end[kMaxConstraints];
};

static_assert(sizeof(CombParams) <= 4096, "a kernel parameter holds at most 4 KB before CUDA 12.1");

}  // namespace stark

namespace {

using stark::CombParams;
using stark::Fe;
using stark::fe_add;
using stark::fe_load;
using stark::fe_mul;
using stark::fe_store;
using stark::kMaxFactors;
using stark::kThreads;

template <bool kNextRows>
__global__ void __launch_bounds__(kThreads) combination_kernel(const __grid_constant__ CombParams p) {
    extern __shared__ Fe slots[];  // slots[s * blockDim.x + threadIdx.x]
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= p.n) return;
    const int64_t n = p.n;
    const int64_t next = i + p.expansion >= n ? i + p.expansion - n : i + p.expansion;
    Fe* const mine = slots + threadIdx.x;
    const int stride = blockDim.x;

#pragma unroll 1
    for (int s = 0; s < p.n_powers; ++s) {
        const int base = p.pow_base[s], mul = p.pow_mul[s];
        Fe v;
        if (base < 0) {
            if constexpr (kNextRows) {
                v = mul < p.n_trace ? fe_load(p.trace[mul], n, i) : fe_load(p.next[mul - p.n_trace], n, i);
            } else {
                v = mul < p.n_trace ? fe_load(p.trace[mul], n, i) : fe_load(p.trace[mul - p.n_trace], n, next);
            }
        } else {
            const Fe h = mine[base * stride];
            v = fe_mul(h, h);
            if (mul >= 0) v = fe_mul(v, mine[mul * stride]);
        }
        mine[s * stride] = v;
    }

    Fe comb = fe_mul(fe_load(p.weights, p.n_weights, 0), fe_load(p.rand, n, i));
    int k = 1;  // the next weight
    int t = 0;  // the next term
#pragma unroll 1
    for (int c = 0; c < p.n_constraints; ++c) {
        Fe air = {{0u, 0u, 0u, 0u}};
#pragma unroll 1
        for (; t < p.constraint_end[c]; ++t) {
            Fe term = fe_load(p.groups[p.term_group[t]], n, i);
#pragma unroll 1
            for (int f = 0; f < kMaxFactors && p.term_slots[t][f] >= 0; ++f) {
                term = fe_mul(term, mine[p.term_slots[t][f] * stride]);
            }
            air = fe_add(air, term);
        }
        const Fe q = fe_mul(air, fe_load(p.tz_inv[c], n, i));
        fe_store(p.tqs + static_cast<int64_t>(c) * 8 * n, n, i, q);
        comb = fe_add(comb, fe_mul(fe_load(p.weights, p.n_weights, k), q));
        comb = fe_add(comb, fe_mul(fe_load(p.weights, p.n_weights, k + 1), fe_mul(fe_load(p.tq_shift[c], n, i), q)));
        k += 2;
    }
#pragma unroll 1
    for (int b = 0; b < p.n_bq; ++b) {
        const Fe q = fe_load(p.bq[b], n, i);
        comb = fe_add(comb, fe_mul(fe_load(p.weights, p.n_weights, k), q));
        comb = fe_add(comb, fe_mul(fe_load(p.weights, p.n_weights, k + 1), fe_mul(fe_load(p.bq_shift[b], n, i), q)));
        k += 2;
    }
    fe_store(p.comb, n, i, comb);
}

}  // namespace

// The host's copy of CombParams must have this size (the wrapper checks).
extern "C" int stark_combination_params_size() { return static_cast<int>(sizeof(CombParams)); }

// One launch over the n points; *params is copied into the kernel's
// parameter by value.  Refuses counts beyond the limits.  With the next
// pointers set it launches the next-row instantiation.
extern "C" int stark_combination(const CombParams* params, void* stream) {
    using namespace stark;
    const CombParams& p = *params;
    if (p.n <= 0 || p.expansion < 0 || p.expansion >= p.n || p.n_trace < 1 || p.n_trace > kMaxTrace ||
        p.n_powers < 0 || p.n_powers > kMaxPowers || p.n_constraints < 0 || p.n_constraints > kMaxConstraints ||
        p.n_bq < 0 || p.n_bq > kMaxBq || p.n_groups < 0 || p.n_groups > kMaxGroups ||
        p.n_weights != 1 + 2 * (p.n_constraints + p.n_bq))
        return cudaErrorInvalidValue;
    // the program reads only what it was given: earlier slots, state
    // columns that exist, group codewords that were passed
    for (int s = 0; s < p.n_powers; ++s) {
        const int base = p.pow_base[s], mul = p.pow_mul[s];
        if (base < 0 ? mul < 0 || mul >= 2 * p.n_trace : base >= s || mul >= s) return cudaErrorInvalidValue;
    }
    for (int c = 0, t = 0; c < p.n_constraints; ++c) {
        if (p.constraint_end[c] < t || p.constraint_end[c] > kMaxTerms) return cudaErrorInvalidValue;
        for (; t < p.constraint_end[c]; ++t) {
            if (p.term_group[t] >= p.n_groups) return cudaErrorInvalidValue;
            for (int f = 0; f < kMaxFactors; ++f)
                if (p.term_slots[t][f] >= p.n_powers) return cudaErrorInvalidValue;
        }
    }
    // the next-row operand: every trace column's planes or none
    const bool next_rows = p.next[0] != nullptr;
    for (int j = 0; j < kMaxTrace; ++j)
        if ((p.next[j] != nullptr) != (next_rows && j < p.n_trace)) return cudaErrorInvalidValue;
    const size_t smem = static_cast<size_t>(p.n_powers > 0 ? p.n_powers : 1) * kThreads * sizeof(Fe);
    // above 48 KB only after opting in; the limit is the current device's, so opt in at every launch
    const auto kernel = next_rows ? combination_kernel<true> : combination_kernel<false>;
    const cudaError_t opt_in = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                    static_cast<int>(kMaxPowers * kThreads * sizeof(Fe)));
    if (opt_in != cudaSuccess) return opt_in;
    const unsigned blocks = static_cast<unsigned>((p.n + kThreads - 1) / kThreads);
    kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
    return cudaGetLastError();
}
