"""The digit conversion out of Montgomery form (one product an element),
whole codewords or gathered values."""

from . import ELEMENT_BYTES, FIELD_PRODUCT

KERNELS = ("mont_digits_kernel", "mont_digits_gather_kernel")
LAUNCHES = ("mont_digits", "mont_digits_gather")


def count(key, args, size):
    n = int(size)
    return n * FIELD_PRODUCT, 2 * n * ELEMENT_BYTES
