"""K11, the combination over n points.  Products a point: one for each
group (its univariate codeword times its monomial; the monomials
themselves not counted), one for each transition quotient (the AIR value
times the zeroifier's inverse), three for each quotient (its weight, its
x^shift and that term's weight) and one for the randomizer.  Bytes: the
trace codewords, each distinct zeroifier inverse, the randomizer and the
boundary quotients read, the combination written (the group codewords,
the x^shift tables and the quotients it also writes not counted)."""

from . import ELEMENT_BYTES, FIELD_PRODUCT

KERNELS = ("combination_kernel",)
LAUNCHES = ("combination", "combination_next")


def _params(address):
    from stark_tpu_torch.ops.cuda_combination import _Params

    return _Params.from_address(int(address))


def count(key, args, size):
    p = _params(args[0])
    n, k, b = int(p.n), int(p.n_constraints), int(p.n_bq)
    products = int(p.n_groups) + k + 3 * (k + b) + 1
    zeroifiers = len({int(p.tz_inv[i]) for i in range(k)})
    codewords = int(p.n_trace) + zeroifiers + 1 + b + 1
    return n * products * FIELD_PRODUCT, n * codewords * ELEMENT_BYTES
