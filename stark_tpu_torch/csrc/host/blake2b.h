#ifndef STARK_TPU_BLAKE2B_H
#define STARK_TPU_BLAKE2B_H

#include <stddef.h>
#include <stdint.h>

/* One-shot BLAKE2b with parameterizable digest length (1..64 bytes). */
void blake2b_hash(const uint8_t *data, size_t len, uint8_t *out,
                  size_t digest_len);

#endif
