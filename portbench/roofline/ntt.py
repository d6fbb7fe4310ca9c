"""K2 / K3, the two passes of the four-step NTT of R * C points: pass 1
the C column transforms of R points and the twiddles W, pass 2 the R row
transforms of C points; either may scale by the coset's row and column
multipliers."""

from . import ELEMENT_BYTES, FIELD_PRODUCT

KERNELS = ("ntt_pass_kernel",)
LAUNCHES = ("ntt_pass1", "ntt_pass2")


def count(key, args, size):
    log_r, log_c = int(args[2]), int(args[3])
    r, c = 1 << log_r, 1 << log_c
    n = r * c
    if key == "ntt_pass1":
        products = (r // 2) * log_r * c + n  # butterflies, W
        scaled = args[6] not in (None, 0)
    else:
        products = (c // 2) * log_c * r
        scaled = args[5] not in (None, 0)
    if scaled:
        products += n  # the coset's multiplier, one product an element
    return products * FIELD_PRODUCT, 2 * n * ELEMENT_BYTES
