"""Host-side golden model of GF(p), p = 1 + 407 * 2^119.

This is the exact, obviously-correct scalar implementation backed by Python
integers.  It defines the semantics that the batched device kernels in
:mod:`stark_tpu_torch.ops` are differential-tested against, and it is fast enough
for all host-side protocol bookkeeping (AIR construction, verifier logic,
small interpolations).

Semantics mirror the reference implementation exactly
(reference: field.rs:16-147):

* values are canonical residues in [0, p);
* ``sample`` folds a byte string big-endian into an integer and reduces;
* ``primitive_nth_root`` only supports power-of-two n <= 2^119 and derives
  the root by repeated squaring of the generator.
"""

from __future__ import annotations

import os

from .params import GENERATOR, P, TWO_ADICITY


class FieldElement:
    """An element of GF(p) as a canonical residue (Python int).

    Cheap value type; supports +, -, *, /, unary -, ** and equality.
    """

    __slots__ = ("value",)

    def __init__(self, value: int) -> None:
        self.value = value % P

    # -- constructors -----------------------------------------------------

    @staticmethod
    def zero() -> "FieldElement":
        return FieldElement(0)

    @staticmethod
    def one() -> "FieldElement":
        return FieldElement(1)

    @staticmethod
    def generator() -> "FieldElement":
        """Generator of the order-2^119 subgroup (reference: field.rs:29)."""
        return FieldElement(GENERATOR)

    @staticmethod
    def modulus() -> int:
        return P

    @staticmethod
    def sample(data: bytes) -> "FieldElement":
        """Big-endian byte fold mod p (reference: field.rs:110-116)."""
        return FieldElement(int.from_bytes(bytes(data), "big") % P)

    @staticmethod
    def random(rng_bytes=os.urandom) -> "FieldElement":
        """A uniformly-ish random element, via 17 sampled bytes.

        The reference draws 17 random bytes then ``sample``s them wherever it
        needs proof randomness (reference: stark.rs:244-250); the injectable
        ``rng_bytes`` callable is the determinism seam used by tests.
        """
        return FieldElement.sample(rng_bytes(17))

    @staticmethod
    def primitive_nth_root(n: int) -> "FieldElement":
        """Primitive nth root of unity for power-of-two n <= 2^119.

        (reference: field.rs:96-107)
        """
        if n > (1 << TWO_ADICITY) or (n & (n - 1)) != 0 or n <= 0:
            raise ValueError(
                "field has no nth root of unity for n > 2^119 or non-power-of-two"
            )
        root = GENERATOR
        order = 1 << TWO_ADICITY
        while order != n:
            root = root * root % P
            order //= 2
        return FieldElement(root)

    # -- predicates -------------------------------------------------------

    def is_zero(self) -> bool:
        return self.value == 0

    # -- arithmetic -------------------------------------------------------

    def __add__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(self.value + other.value)

    def __sub__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(self.value - other.value)

    def __mul__(self, other: "FieldElement") -> "FieldElement":
        return FieldElement(self.value * other.value)

    def __truediv__(self, other: "FieldElement") -> "FieldElement":
        return self * other.inverse()

    def __neg__(self) -> "FieldElement":
        return FieldElement(-self.value)

    def __pow__(self, exponent: int) -> "FieldElement":
        return FieldElement(pow(self.value, exponent, P))

    def pow(self, exponent: int) -> "FieldElement":
        return self.__pow__(exponent)

    def inverse(self) -> "FieldElement":
        """Multiplicative inverse (reference: field.rs:67-93 ext. Euclid)."""
        if self.value == 0:
            raise ZeroDivisionError("inverse of zero field element")
        return FieldElement(pow(self.value, -1, P))

    # -- dunder plumbing --------------------------------------------------

    def __eq__(self, other: object) -> bool:
        return isinstance(other, FieldElement) and self.value == other.value

    def __hash__(self) -> int:
        return hash(self.value)

    def __repr__(self) -> str:
        return f"FieldElement({self.value})"

    def __str__(self) -> str:
        # Decimal rendering; FRI query points are transported as decimal
        # strings (reference: fri.rs:169-178).
        return str(self.value)


ZERO = FieldElement(0)
ONE = FieldElement(1)
