/* Batched hashing / Merkle kernels for stark_tpu (host-native layer).
 *
 * The TPU does the field arithmetic; commitments are Blake2b Merkle trees
 * over bincode-serialized field elements (see stark_tpu/serialization.py
 * for the format).  These loops are embarrassingly parallel — OpenMP
 * across leaves/nodes.
 *
 * Exposed via ctypes (stark_tpu/native/hashing_native.py).
 */

#include <stdint.h>
#include <string.h>

#include "blake2b.h"

#ifdef _OPENMP
#include <omp.h>
#endif

/* Hash n variable-length items packed in `data` at `offsets` (n+1 entries:
 * item i is data[offsets[i] .. offsets[i+1])), 32-byte digests to out. */
void batch_blake2b_256(const uint8_t *data, const uint64_t *offsets,
                       uint64_t n, uint8_t *out) {
  int64_t i;
#pragma omp parallel for schedule(static)
  for (i = 0; i < (int64_t)n; i++) {
    blake2b_hash(data + offsets[i], (size_t)(offsets[i + 1] - offsets[i]),
                 out + 32 * i, 32);
  }
}

/* One interior Merkle level: 2k 32-byte child digests -> k parent digests. */
void merkle_level(const uint8_t *children, uint64_t n_parents, uint8_t *out) {
  int64_t i;
#pragma omp parallel for schedule(static)
  for (i = 0; i < (int64_t)n_parents; i++) {
    blake2b_hash(children + 64 * i, 64, out + 32 * i, 32);
  }
}

/* bincode(FieldElement) for a 128-bit value given as 4 LE u32 digits:
 *   u32 LE sign (1 = NoSign for zero, 2 = Plus), u64 LE digit count,
 *   digits (LE u32, no trailing zeros).  Returns encoded length. */
static size_t bincode_fe(const uint32_t d[4], uint8_t *buf) {
  uint32_t nd = 4;
  while (nd > 0 && d[nd - 1] == 0) nd--;
  uint32_t sign = nd == 0 ? 1u : 2u;
  memcpy(buf, &sign, 4);
  uint64_t cnt = nd;
  memcpy(buf + 4, &cnt, 8);
  memcpy(buf + 12, d, 4 * nd);
  return 12 + 4 * nd;
}

/* Fused serialize+hash: digits[4*i..4*i+4) (LE u32) per element ->
 * 32-byte leaf digest of bincode(FieldElement). */
void merkle_leaves_u128(const uint32_t *digits, uint64_t n, uint8_t *out) {
  int64_t i;
#pragma omp parallel for schedule(static)
  for (i = 0; i < (int64_t)n; i++) {
    uint8_t buf[28];
    size_t len = bincode_fe(digits + 4 * i, buf);
    blake2b_hash(buf, len, out + 32 * i, 32);
  }
}

/* Full Merkle tree over n (power of two) leaf digests already computed:
 * levels are packed consecutively into `out_levels`
 * (n digests, then n/2, ... then 1); total 2n-1 digests = 32*(2n-1) bytes.
 * The leaf level is copied from `leaf_digests`. */
void merkle_tree_from_leaves(const uint8_t *leaf_digests, uint64_t n,
                             uint8_t *out_levels) {
  memcpy(out_levels, leaf_digests, 32 * n);
  uint8_t *prev = out_levels;
  uint64_t width = n;
  while (width > 1) {
    uint8_t *cur = prev + 32 * width;
    merkle_level(prev, width / 2, cur);
    prev = cur;
    width /= 2;
  }
}
