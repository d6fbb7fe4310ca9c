/* Vectorized host-native field kernels over GF(p), p = 1 + 407*2^119.
 *
 * The host (non-device) prover path spends its time in size-512..8192
 * radix-2 NTTs and pointwise codeword algebra executed as CPython
 * big-int loops (~0.3us per multiply).  These kernels run the same
 * arithmetic in two-limb Montgomery form with __int128 products
 * (~5 ns per multiply) — a pure performance seam: all outputs are
 * canonical plain residues, bit-identical to the Python golden model
 * (stark_tpu/ntt.py, stark_tpu/hostops.py), which remains the source
 * of truth and is pinned by differential tests.
 *
 * Data layout at the boundary: arrays of 16-byte little-endian plain
 * residues (u64 lo, u64 hi per element), the same layout as
 * native/rescue.c.  Montgomery-form variants (suffix _mont) let
 * composite pipelines stay in Montgomery domain between calls.
 *
 * Reference semantics: NTT = the DFT of ntt.rs:25-107 (values are
 * implementation-independent canonical residues; the DIT schedule here
 * matches stark_tpu/ntt.py only for clarity, not correctness).
 *
 * Exposed via ctypes (stark_tpu/native/fieldvec.py).
 */

#include <stdint.h>
#include <stdlib.h>

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

static inline fe fe_sub(fe a, fe b) {
  u64 lo = a.lo - b.lo;
  u64 hi = a.hi - b.hi - (a.lo < b.lo);
  int borrow = (a.hi < b.hi) || (a.hi == b.hi && a.lo < b.lo);
  if (borrow) { /* wrap: add p back */
    u128 s = (u128)lo + P_LO;
    lo = (u64)s;
    hi = hi + P_HI + (u64)(s >> 64);
  }
  fe r = {lo, hi};
  return r;
}

/* Two-limb CIOS Montgomery multiply: a*b*2^-128 mod p, canonical. */
static inline fe mont_mul(fe a, fe b) {
  u64 t0, t1, t2, m;
  u128 c;

  c = (u128)a.lo * b.lo;
  t0 = (u64)c;
  c = (u128)a.lo * b.hi + (u64)(c >> 64);
  t1 = (u64)c;
  t2 = (u64)(c >> 64);

  m = t0 * N0INV;
  c = (u128)m * P_LO + t0;
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
static int fv_tables_ready = 0;

/* Load-time init (no lazy-init data race under concurrent ctypes calls,
 * which release the GIL). */
__attribute__((constructor)) static void fv_init_tables(void) {
  fe x = {1, 0};
  for (int i = 0; i < 256; i++) {
    x = fe_add(x, x);
    if (i == 127) ONE_MONT = x;
  }
  R2 = x;
  fv_tables_ready = 1;
}

static inline fe to_mont(fe a) { return mont_mul(a, R2); }

static inline fe from_mont(fe a) {
  fe one = {1, 0};
  return mont_mul(a, one);
}

/* MSB-first square-and-multiply, Montgomery in/out, <=128-bit exponent. */
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

/* x^{p-2} (Fermat inverse), Montgomery in/out.  p-2 = 407*2^119 - 1. */
static inline fe mont_inv(fe x) {
  const u64 pm2_hi = P_HI; /* p-2 = (P_HI<<64) | (P_LO-2+2^64... ) */
  /* p = (P_HI << 64) + 1, so p-2 = ((P_HI-1) << 64) + (2^64 - 1). */
  return mont_pow(x, pm2_hi - 1, 0xFFFFFFFFFFFFFFFFULL);
}

static inline fe load_fe(const u64 *p) {
  fe r = {p[0], p[1]};
  return r;
}

static inline void store_fe(u64 *p, fe v) {
  p[0] = v.lo;
  p[1] = v.hi;
}

/* ---------------------------------------------------------------- */
/* elementwise vector ops (ctypes API)                              */
/* ---------------------------------------------------------------- */

void fv_to_mont(u64 *data, u64 n) {
  if (!fv_tables_ready) fv_init_tables();
  for (u64 i = 0; i < n; i++) store_fe(data + 2 * i, to_mont(load_fe(data + 2 * i)));
}

void fv_from_mont(u64 *data, u64 n) {
  if (!fv_tables_ready) fv_init_tables();
  for (u64 i = 0; i < n; i++) store_fe(data + 2 * i, from_mont(load_fe(data + 2 * i)));
}

/* out = a * b elementwise; Montgomery domain in/out. */
void fv_mul_mont(const u64 *a, const u64 *b, u64 *out, u64 n) {
  if (!fv_tables_ready) fv_init_tables();
  for (u64 i = 0; i < n; i++)
    store_fe(out + 2 * i, mont_mul(load_fe(a + 2 * i), load_fe(b + 2 * i)));
}

/* add/sub are Montgomery-domain agnostic. */
void fv_add(const u64 *a, const u64 *b, u64 *out, u64 n) {
  for (u64 i = 0; i < n; i++)
    store_fe(out + 2 * i, fe_add(load_fe(a + 2 * i), load_fe(b + 2 * i)));
}

void fv_sub(const u64 *a, const u64 *b, u64 *out, u64 n) {
  for (u64 i = 0; i < n; i++)
    store_fe(out + 2 * i, fe_sub(load_fe(a + 2 * i), load_fe(b + 2 * i)));
}

/* out = a * s elementwise, s a Montgomery-form scalar. */
void fv_scale_mont(const u64 *a, u64 s_lo, u64 s_hi, u64 *out, u64 n) {
  if (!fv_tables_ready) fv_init_tables();
  fe s = {s_lo, s_hi};
  for (u64 i = 0; i < n; i++)
    store_fe(out + 2 * i, mont_mul(load_fe(a + 2 * i), s));
}

/* acc += w1*cw + w2*xs*cw elementwise (the combination inner term);
 * all Montgomery domain, w1/w2 Montgomery scalars. */
void fv_comb_term_mont(u64 *acc, const u64 *cw, const u64 *xs, u64 w1_lo,
                       u64 w1_hi, u64 w2_lo, u64 w2_hi, u64 n) {
  if (!fv_tables_ready) fv_init_tables();
  fe w1 = {w1_lo, w1_hi}, w2 = {w2_lo, w2_hi};
  for (u64 i = 0; i < n; i++) {
    fe c = load_fe(cw + 2 * i);
    fe t = fe_add(mont_mul(w1, c),
                  mont_mul(w2, mont_mul(load_fe(xs + 2 * i), c)));
    store_fe(acc + 2 * i, fe_add(load_fe(acc + 2 * i), t));
  }
}

/* out[i] = start * base^i (plain-residue in, plain-residue out). */
void fv_geom(u64 base_lo, u64 base_hi, u64 start_lo, u64 start_hi, u64 *out,
             u64 n) {
  if (!fv_tables_ready) fv_init_tables();
  fe b = to_mont(load_fe((u64[]){base_lo, base_hi}));
  fe cur = to_mont(load_fe((u64[]){start_lo, start_hi}));
  for (u64 i = 0; i < n; i++) {
    store_fe(out + 2 * i, from_mont(cur));
    cur = mont_mul(cur, b);
  }
}

/* The 16-bit limbs of v into column i of an (8, rows) limb block. */
static inline void store_limbs(uint32_t *block, u64 rows, u64 i, fe v) {
  for (int l = 0; l < 4; l++) {
    block[l * rows + i] = (uint32_t)((v.lo >> (16 * l)) & 0xFFFF);
    block[(l + 4) * rows + i] = (uint32_t)((v.hi >> (16 * l)) & 0xFFFF);
  }
}

/* The Fibonacci trace (a, b) -> (a + b, a) mod p from the canonical
 * seeds (a0, b0), rows = steps + 1, written as the prover's limb trace:
 * out[(r * 8 + l) * rows + i] holds bits [16l, 16l + 16) of register r
 * at row i (the (registers, 8, rows) uint32 layout of ops/limbs.py). */
void fv_fib_trace_limbs(u64 a_lo, u64 a_hi, u64 b_lo, u64 b_hi, u64 steps,
                        uint32_t *out) {
  u64 rows = steps + 1;
  fe a = {a_lo, a_hi}, b = {b_lo, b_hi};
  for (u64 i = 0; i < rows; i++) {
    store_limbs(out, rows, i, a);
    store_limbs(out + 8 * rows, rows, i, b);
    fe next = fe_add(a, b);
    b = a;
    a = next;
  }
}

/* Batch inversion (Montgomery trick): plain residues in/out.  Zero
 * inputs are rejected by returning -1 (caller falls back). */
int fv_batch_inverse(const u64 *a, u64 *out, u64 n) {
  if (!fv_tables_ready) fv_init_tables();
  if (n == 0) return 0;
  fe *prefix = malloc(sizeof(fe) * n);
  if (!prefix) return -2;
  fe acc = ONE_MONT;
  for (u64 i = 0; i < n; i++) {
    fe v = to_mont(load_fe(a + 2 * i));
    if (v.lo == 0 && v.hi == 0) {
      free(prefix);
      return -1;
    }
    prefix[i] = acc; /* product of a[0..i) in mont */
    acc = mont_mul(acc, v);
  }
  fe inv = mont_inv(acc);
  for (u64 i = n; i-- > 0;) {
    fe v = to_mont(load_fe(a + 2 * i));
    store_fe(out + 2 * i, from_mont(mont_mul(inv, prefix[i])));
    inv = mont_mul(inv, v);
  }
  free(prefix);
  return 0;
}

/* ---------------------------------------------------------------- */
/* batched radix-2 coset NTT                                        */
/* ---------------------------------------------------------------- */

/* In-place DIT butterfly pass over one row of n Montgomery elements,
 * with stage twiddle tables tw (flat: stage s of size 2^s halves). */
static void ntt_row(fe *a, u64 n, const fe *stage_tw) {
  /* bit-reversal permutation */
  u64 j = 0;
  for (u64 i = 1; i < n; i++) {
    u64 bit = n >> 1;
    while (j & bit) {
      j ^= bit;
      bit >>= 1;
    }
    j ^= bit;
    if (i < j) {
      fe t = a[i];
      a[i] = a[j];
      a[j] = t;
    }
  }
  const fe *tw = stage_tw;
  for (u64 length = 2; length <= n; length <<= 1) {
    u64 half = length >> 1;
    for (u64 i = 0; i < n; i += length) {
      for (u64 k = 0; k < half; k++) {
        fe u = a[i + k];
        fe v = mont_mul(a[i + k + half], tw[k]);
        a[i + k] = fe_add(u, v);
        a[i + k + half] = fe_sub(u, v);
      }
    }
    tw += half;
  }
}

/* Batched coset NTT, in/out plain residues, in-place over `data`
 * (batch rows of n elements each).
 *
 * forward (inverse=0): row[j] *= offset^j, then DFT with omega.
 * inverse (inverse=1): inverse DFT (omega^{-1}), scale by n^{-1},
 *                      then row[j] *= offset^{-j}.
 *
 * omega must be a primitive n-th root of unity (the FORWARD root in
 * both directions); offset = 1 gives the plain transform.  Returns 0,
 * or -1 on invalid n / allocation failure. */
int fv_coset_ntt_batch(u64 *data, u64 batch, u64 n, u64 om_lo, u64 om_hi,
                       u64 off_lo, u64 off_hi, int inverse) {
  if (!fv_tables_ready) fv_init_tables();
  if (n == 0 || (n & (n - 1)) != 0) return -1;
  if (n == 1) return 0;

  fe omega = to_mont(load_fe((u64[]){om_lo, om_hi}));
  fe offset = to_mont(load_fe((u64[]){off_lo, off_hi}));
  if (inverse) {
    omega = mont_inv(omega);
    offset = mont_inv(offset);
  }

  /* stage twiddles: for each length L = 2,4,..,n the first L/2 powers
   * of omega^{n/L}; flat size n-1 */
  fe *tw = malloc(sizeof(fe) * (n - 1));
  fe *offp = malloc(sizeof(fe) * n); /* offset^j, Montgomery */
  fe *row = malloc(sizeof(fe) * n);
  if (!tw || !offp || !row) {
    free(tw);
    free(offp);
    free(row);
    return -1;
  }
  fe *t = tw;
  for (u64 length = 2; length <= n; length <<= 1) {
    u64 half = length >> 1;
    /* w = omega^(n/length) via repeated squaring of omega */
    fe w = omega;
    for (u64 m = length; m < n; m <<= 1) w = mont_mul(w, w);
    fe cur = ONE_MONT;
    for (u64 k = 0; k < half; k++) {
      t[k] = cur;
      cur = mont_mul(cur, w);
    }
    t += half;
  }
  fe cur = ONE_MONT;
  for (u64 j = 0; j < n; j++) {
    offp[j] = cur;
    cur = mont_mul(cur, offset);
  }
  /* n^{-1} as a Montgomery scalar (inverse transform only) */
  fe n_inv = ONE_MONT;
  if (inverse) {
    fe nm = {n, 0};
    n_inv = mont_inv(to_mont(nm));
  }

  for (u64 b = 0; b < batch; b++) {
    u64 *base = data + 2 * b * n;
    if (!inverse) {
      for (u64 j = 0; j < n; j++)
        row[j] = mont_mul(to_mont(load_fe(base + 2 * j)), offp[j]);
      ntt_row(row, n, tw);
      for (u64 j = 0; j < n; j++) store_fe(base + 2 * j, from_mont(row[j]));
    } else {
      for (u64 j = 0; j < n; j++) row[j] = to_mont(load_fe(base + 2 * j));
      ntt_row(row, n, tw);
      for (u64 j = 0; j < n; j++)
        store_fe(base + 2 * j,
                 from_mont(mont_mul(mont_mul(row[j], n_inv), offp[j])));
    }
  }
  free(tw);
  free(offp);
  free(row);
  return 0;
}

/* Multi-point Horner evaluation: out[t] = p(xs[t]) for a coefficient
 * vector (lowest-first) of length n; plain residues in/out.  (k+1)*n
 * Montgomery multiplies — the memory-light alternative to RS-extending
 * a whole coset to read k points. */
int fv_poly_eval_many(const u64 *coeffs, u64 n, const u64 *xs, u64 k,
                      u64 *out) {
  if (!fv_tables_ready) fv_init_tables();
  if (n == 0) {
    for (u64 t = 0; t < k; t++) {
      out[2 * t] = 0;
      out[2 * t + 1] = 0;
    }
    return 0;
  }
  fe *cm = malloc(sizeof(fe) * n);
  if (!cm) return -2;
  for (u64 j = 0; j < n; j++) cm[j] = to_mont(load_fe(coeffs + 2 * j));
  for (u64 t = 0; t < k; t++) {
    fe x = to_mont(load_fe(xs + 2 * t));
    fe acc = cm[n - 1];
    for (u64 j = n - 1; j-- > 0;) acc = fe_add(mont_mul(acc, x), cm[j]);
    store_fe(out + 2 * t, from_mont(acc));
  }
  free(cm);
  return 0;
}

/* FRI fold: out[i] = 2^{-1} * ((1 + alpha*inv_i)*cw[i]
 *                              + (1 - alpha*inv_i)*cw[i + half])
 * with inv_i = (offset * omega^i)^{-1}; plain residues in/out
 * (semantics: reference fri.rs:133-139, one table inversion instead of
 * two extended-Euclid inversions per element). */
int fv_fri_fold(const u64 *cw, u64 n, u64 alpha_lo, u64 alpha_hi, u64 off_lo,
                u64 off_hi, u64 om_lo, u64 om_hi, u64 *out) {
  if (!fv_tables_ready) fv_init_tables();
  if (n == 0 || (n & 1)) return -1;
  u64 half = n / 2;
  fe alpha = to_mont(load_fe((u64[]){alpha_lo, alpha_hi}));
  fe off = to_mont(load_fe((u64[]){off_lo, off_hi}));
  fe omega = to_mont(load_fe((u64[]){om_lo, om_hi}));
  fe base_inv = mont_inv(off); /* (offset)^{-1} */
  fe om_inv = mont_inv(omega);
  fe two = {2, 0};
  fe two_inv = mont_inv(to_mont(two));
  fe cur = base_inv;
  for (u64 i = 0; i < half; i++) {
    fe ai = mont_mul(alpha, cur);
    fe l = fe_add(ONE_MONT, ai);
    fe r = fe_sub(ONE_MONT, ai);
    fe lo = mont_mul(l, to_mont(load_fe(cw + 2 * i)));
    fe hi = mont_mul(r, to_mont(load_fe(cw + 2 * (i + half))));
    store_fe(out + 2 * i, from_mont(mont_mul(two_inv, fe_add(lo, hi))));
    cur = mont_mul(cur, om_inv);
  }
  return 0;
}
