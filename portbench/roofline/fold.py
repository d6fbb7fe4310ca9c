"""K6, one FRI fold of n points to n / 2: two products an output
(alpha times the inverse point, times the difference of the pair)."""

from . import ELEMENT_BYTES, FIELD_PRODUCT

KERNELS = ("fold_kernel",)
LAUNCHES = ("fri_fold",)


def count(key, args, size):
    half = int(args[4])
    return 2 * half * FIELD_PRODUCT, 3 * half * ELEMENT_BYTES
