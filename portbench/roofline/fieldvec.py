"""The field vector kernels K7-K10: a batch inversion (three products an
element), a prefix product and a power table (one product an element
after the first), the elementwise product, sum or difference (K10:
products only for the product; each operand that is not a broadcast
column is read) and its row-by-column form."""

from . import ELEMENT_BYTES, FIELD_PRODUCT

KERNELS = ("inv_kernel", "scan_kernel", "geometric_kernel", "binary_kernel", "outer_kernel")
LAUNCHES = ("mont_inv", "prefix_mul", "geometric_table", "mont_binary", "mont_outer")
MUL = 0


def count(key, args, size):
    if key == "mont_inv":
        n = int(args[2])
        return 3 * max(n - 1, 0) * FIELD_PRODUCT, 2 * n * ELEMENT_BYTES
    if key == "prefix_mul":
        n = int(args[2])
        return max(n - 1, 0) * FIELD_PRODUCT, 2 * n * ELEMENT_BYTES
    if key == "geometric_table":
        n = int(args[4])
        return max(n - 1, 0) * FIELD_PRODUCT, n * ELEMENT_BYTES
    if key == "mont_binary":
        n, op, a_col, b_col = int(args[3]), int(args[4]), int(args[5]), int(args[6])
        full_inputs = (0 if a_col else 1) + (0 if b_col else 1)
        return (n * FIELD_PRODUCT if op == MUL else 0), (full_inputs + 1) * n * ELEMENT_BYTES
    rows, cols = int(args[3]), int(args[4])
    return rows * cols * FIELD_PRODUCT, (rows * cols + rows + cols) * ELEMENT_BYTES
