/* SHAKE256 (FIPS 202) for the batched deterministic-rng fast path.
 *
 * stark_tpu.rng.DeterministicRandom derives chunk i as
 * SHAKE256(seed || le64(counter_i)) — one tiny independent message per
 * chunk, which makes the batch embarrassingly parallel.  The randomizer
 * polynomial draws ~2^17 such chunks per large proof; one hashlib call
 * per chunk costs ~0.5 s of Python/allocator overhead, this loop does
 * the same work in a few ms (OpenMP across chunks).
 *
 * Only the single-absorb-block / single-squeeze-block case is handled
 * (message <= 135 bytes, output <= 136 bytes); the Python wrapper falls
 * back to hashlib otherwise.  Keccak-f[1600] written from FIPS 202.
 */

#include <stdint.h>
#include <string.h>

#ifdef _OPENMP
#include <omp.h>
#endif

#define KECCAK_ROUNDS 24
#define SHAKE256_RATE 136

static const uint64_t keccak_rc[KECCAK_ROUNDS] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

/* rotation offsets for the rho step, indexed by lane (x + 5y) */
static const unsigned keccak_rho[25] = {
    0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
    25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14,
};

/* lane index map for the pi step: dst[pi[i]] = src[i] */
static const unsigned keccak_pi[25] = {
    0,  10, 20, 5,  15, 16, 1,  11, 21, 6,  7,  17, 2,
    12, 22, 23, 8,  18, 3,  13, 14, 24, 9,  19, 4,
};

static inline uint64_t rotl64(uint64_t x, unsigned n) {
  return n == 0 ? x : (x << n) | (x >> (64 - n));
}

static void keccakf(uint64_t st[25]) {
  uint64_t bc[5], t;
  for (int round = 0; round < KECCAK_ROUNDS; round++) {
    /* theta */
    for (int x = 0; x < 5; x++)
      bc[x] = st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20];
    for (int x = 0; x < 5; x++) {
      t = bc[(x + 4) % 5] ^ rotl64(bc[(x + 1) % 5], 1);
      for (int y = 0; y < 25; y += 5) st[x + y] ^= t;
    }
    /* rho + pi */
    uint64_t tmp[25];
    for (int i = 0; i < 25; i++) tmp[keccak_pi[i]] = rotl64(st[i], keccak_rho[i]);
    /* chi */
    for (int y = 0; y < 25; y += 5) {
      for (int x = 0; x < 5; x++) bc[x] = tmp[y + x];
      for (int x = 0; x < 5; x++)
        st[y + x] = bc[x] ^ (~bc[(x + 1) % 5] & bc[(x + 2) % 5]);
    }
    /* iota */
    st[0] ^= keccak_rc[round];
  }
}

/* SHAKE256 of (seed || le64(counter)), single absorb + squeeze block.
 * Requires seed_len + 8 <= 135 and out_len <= 136 (caller-checked). */
static void shake256_ctr(const uint8_t *seed, size_t seed_len,
                         uint64_t counter, uint8_t *out, size_t out_len) {
  uint8_t block[SHAKE256_RATE];
  memset(block, 0, sizeof(block));
  memcpy(block, seed, seed_len);
  for (int i = 0; i < 8; i++)
    block[seed_len + i] = (uint8_t)(counter >> (8 * i));
  block[seed_len + 8] = 0x1f;       /* SHAKE domain + pad10*1 start */
  block[SHAKE256_RATE - 1] |= 0x80; /* pad10*1 end */

  uint64_t st[25];
  memset(st, 0, sizeof(st));
  for (int i = 0; i < SHAKE256_RATE / 8; i++) {
    uint64_t lane = 0;
    for (int b = 7; b >= 0; b--) lane = (lane << 8) | block[8 * i + b];
    st[i] = lane;
  }
  keccakf(st);

  uint8_t squeezed[SHAKE256_RATE];
  for (int i = 0; i < SHAKE256_RATE / 8; i++)
    for (int b = 0; b < 8; b++) squeezed[8 * i + b] = (uint8_t)(st[i] >> (8 * b));
  memcpy(out, squeezed, out_len);
}

/* out[i*out_len .. ) = SHAKE256(seed || le64(counter_start + i)), i < n.
 * Exactly the byte stream of n sequential DeterministicRandom calls. */
void batch_shake256_ctr(const uint8_t *seed, uint64_t seed_len,
                        uint64_t counter_start, uint64_t n, uint64_t out_len,
                        uint8_t *out) {
  int64_t i;
#pragma omp parallel for schedule(static)
  for (i = 0; i < (int64_t)n; i++) {
    shake256_ctr(seed, (size_t)seed_len, counter_start + (uint64_t)i,
                 out + (size_t)out_len * (size_t)i, (size_t)out_len);
  }
}
