/* Rescue-Prime hash-chain witness kernel (host-native layer).
 *
 * The chain h_{k+1} = RescuePrime(h_k) is inherently sequential, so it
 * can't ride a device's batch parallelism, and the Python golden model
 * (stark_tpu_torch/rescue_prime.py, reference semantics rescue_prime.rs:
 * 172-293) spends seconds at L=4096 inside CPython big-int pow.  This
 * kernel runs the same permutation in two-limb Montgomery arithmetic
 * with __int128 products — a pure performance seam: outputs are
 * bit-identical plain residues (tests pin equality against the Python
 * model, which remains the source of truth).
 *
 * Field: p = 1 + 407*2^119 (reference field.rs:32).  p ≡ 1 (mod 2^64),
 * so the Montgomery factor for R = 2^128 is n0' = -p^{-1} = 2^64 - 1.
 *
 * Exposed via ctypes (stark_tpu_torch/native/rescue_native.py).
 */

#include <stdint.h>

typedef uint64_t u64;
typedef unsigned __int128 u128;

#define P_LO 1ULL
#define P_HI (407ULL << 55)
#define N0INV 0xFFFFFFFFFFFFFFFFULL /* -p^{-1} mod 2^64 */

typedef struct {
  u64 lo, hi;
} fe;

static inline int geq_p(u64 hi, u64 lo) {
  return hi > P_HI || (hi == P_HI && lo >= P_LO);
}

/* (borrow-propagating) value - p; with an implicit 2^128 bit the wrap
 * mod 2^128 is exactly the borrow absorption. */
static inline fe sub_p(u64 hi, u64 lo) {
  fe r;
  r.lo = lo - P_LO;
  r.hi = hi - P_HI - (lo < P_LO);
  return r;
}

static inline fe fe_add(fe a, fe b) {
  u128 lo = (u128)a.lo + b.lo;
  u128 hi = (u128)a.hi + b.hi + (u64)(lo >> 64);
  u64 rlo = (u64)lo, rhi = (u64)hi;
  if ((u64)(hi >> 64) || geq_p(rhi, rlo)) return sub_p(rhi, rlo);
  fe r = {rlo, rhi};
  return r;
}

/* Two-limb CIOS Montgomery multiply: returns a*b*2^-128 mod p, < p. */
static inline fe mont_mul(fe a, fe b) {
  u64 t0, t1, t2, m;
  u128 c;

  c = (u128)a.lo * b.lo;
  t0 = (u64)c;
  c = (u128)a.lo * b.hi + (u64)(c >> 64);
  t1 = (u64)c;
  t2 = (u64)(c >> 64);

  m = t0 * N0INV;
  c = (u128)m * P_LO + t0; /* low limb cancels */
  c = (u128)m * P_HI + t1 + (u64)(c >> 64);
  t0 = (u64)c;
  c = (u128)t2 + (u64)(c >> 64);
  t1 = (u64)c;
  t2 = (u64)(c >> 64);

  c = (u128)a.hi * b.lo + t0;
  t0 = (u64)c;
  c = (u128)a.hi * b.hi + t1 + (u64)(c >> 64);
  t1 = (u64)c;
  c = (u128)t2 + (u64)(c >> 64);
  t2 = (u64)c;

  m = t0 * N0INV;
  c = (u128)m * P_LO + t0;
  c = (u128)m * P_HI + t1 + (u64)(c >> 64);
  t0 = (u64)c;
  c = (u128)t2 + (u64)(c >> 64);
  t1 = (u64)c;
  t2 = (u64)(c >> 64);

  if (t2 || geq_p(t1, t0)) return sub_p(t1, t0);
  fe r = {t0, t1};
  return r;
}

static fe R2;       /* 2^256 mod p */
static fe ONE_MONT; /* 2^128 mod p */
static int tables_ready = 0;

/* Load-time init (no lazy-init data race under concurrent ctypes calls,
 * which release the GIL). */
__attribute__((constructor)) static void init_tables(void) {
  fe x = {1, 0};
  for (int i = 0; i < 256; i++) {
    x = fe_add(x, x);
    if (i == 127) ONE_MONT = x;
  }
  R2 = x;
  tables_ready = 1;
}

static inline fe to_mont(fe a) { return mont_mul(a, R2); }

static inline fe from_mont(fe a) {
  fe one = {1, 0};
  return mont_mul(a, one);
}

/* MSB-first square-and-multiply for a fixed <=128-bit exponent. */
static fe mont_pow(fe x, u64 e_hi, u64 e_lo) {
  fe acc = ONE_MONT;
  int started = 0;
  for (int i = 127; i >= 0; i--) {
    u64 bit = i >= 64 ? (e_hi >> (i - 64)) & 1 : (e_lo >> i) & 1;
    if (!started) {
      if (!bit) continue;
      started = 1;
      acc = x;
      continue;
    }
    acc = mont_mul(acc, acc);
    if (bit) acc = mont_mul(acc, x);
  }
  return acc;
}

static inline fe cube(fe x) { return mont_mul(mont_mul(x, x), x); }

static inline void record(u64 *w, fe s0m, fe s1m) {
  fe a = from_mont(s0m), b = from_mont(s1m);
  w[0] = a.lo;
  w[1] = a.hi;
  w[2] = b.lo;
  w[3] = b.hi;
}

/* Chain of `num_hashes` Rescue-Prime permutations over the m=2 state,
 * recording ALL (N+1)*num_hashes states.  Semantics mirror
 * stark_tpu_torch/rescue_prime.py _round/trace exactly (reference:
 * rescue_prime.rs:180-293): per round r — S-box x^3, MDS,
 * +consts[2*r*m + i]; S-box x^(1/3), MDS, +consts[2*r*m + m + i].
 * Between segments the digest (register 0 of the last row) is
 * re-absorbed as [digest, 0].
 *
 * mds: 2x2 row-major, consts: 4*n_rounds entries; both plain residues
 * as (lo, hi) u64 pairs.  alpha_inv is the inverse S-box exponent.
 * out: num_hashes*(n_rounds+1) rows x 2 registers x (lo, hi). */
void rescue_chain_trace(u64 in_lo, u64 in_hi, u64 num_hashes,
                        const u64 *mds_limbs, const u64 *const_limbs,
                        u64 n_rounds, u64 alpha_inv_hi, u64 alpha_inv_lo,
                        u64 *out) {
  if (n_rounds > 64) return; /* rc[] is sized for <= 64 rounds */
  if (!tables_ready) init_tables();
  fe mds[4];
  for (int i = 0; i < 4; i++) {
    fe v = {mds_limbs[2 * i], mds_limbs[2 * i + 1]};
    mds[i] = to_mont(v);
  }
  /* 4 constants per round: [c1_0, c1_1, c2_0, c2_1] */
  fe rc[4 * 64];
  for (u64 i = 0; i < 4 * n_rounds; i++) {
    fe v = {const_limbs[2 * i], const_limbs[2 * i + 1]};
    rc[i] = to_mont(v);
  }

  fe in = {in_lo, in_hi};
  fe s0 = to_mont(in), s1 = {0, 0};
  u64 *w = out;
  for (u64 k = 0; k < num_hashes; k++) {
    record(w, s0, s1);
    w += 4;
    for (u64 r = 0; r < n_rounds; r++) {
      fe a = cube(s0), b = cube(s1);
      fe n0 = fe_add(fe_add(mont_mul(mds[0], a), mont_mul(mds[1], b)),
                     rc[4 * r]);
      fe n1 = fe_add(fe_add(mont_mul(mds[2], a), mont_mul(mds[3], b)),
                     rc[4 * r + 1]);
      n0 = mont_pow(n0, alpha_inv_hi, alpha_inv_lo);
      n1 = mont_pow(n1, alpha_inv_hi, alpha_inv_lo);
      s0 = fe_add(fe_add(mont_mul(mds[0], n0), mont_mul(mds[1], n1)),
                  rc[4 * r + 2]);
      s1 = fe_add(fe_add(mont_mul(mds[2], n0), mont_mul(mds[3], n1)),
                  rc[4 * r + 3]);
      record(w, s0, s1);
      w += 4;
    }
    s1.lo = 0; /* re-absorb: [digest, 0] */
    s1.hi = 0;
  }
}
