"""Wire-format encodings, byte-compatible with the reference's Rust stack.

The reference serializes with bincode 1.3 (fixed-int, little-endian) and
serde_json; field elements are `struct FieldElement { value: BigInt }` with
num-bigint 0.4's serde representation.  These byte strings feed Blake2b
(Merkle leaves) and Shake256 (Fiat-Shamir), so they must match exactly for
transcript-level compatibility (reference: merkle.rs:38-51, fri.rs:119,
proof_stream.rs:36-38).

Formats implemented here:

* bincode of `FieldElement`:
    - Sign enum as u32 LE unit-variant index (Minus=0, NoSign=1, Plus=2)
    - magnitude as Vec<u32>: u64 LE length + little-endian u32 digits with
      no trailing zero digits (num-bigint serializes in base-u32 regardless
      of its internal digit size)
* bincode of `Vec<String>` (the proof stream): u64 LE count, then per string
  u64 LE byte length + UTF-8 bytes
* serde_json of `FieldElement`: ``{"value":["Plus",[d0,d1,...]]}``
  (serde tuples render as JSON arrays; serde_json emits no whitespace)
* serde_json of `Vec<FieldElement>`, 3-tuples of strings, and
  `Vec<GenericArray<u8, 32>>` auth paths (arrays of 32 byte values)
"""

from __future__ import annotations

import json
from typing import List, Sequence, Tuple, Union

from .field import FieldElement

IntLike = Union[int, FieldElement]


def _value(x: IntLike) -> int:
    return x.value if isinstance(x, FieldElement) else int(x)


# ---------------------------------------------------------------------------
# bincode
# ---------------------------------------------------------------------------

_SIGN_MINUS = 0
_SIGN_NOSIGN = 1
_SIGN_PLUS = 2


def u32_digits(value: int) -> List[int]:
    """num-bigint's base-2^32 little-endian digit list (empty for zero)."""
    if value < 0:
        raise ValueError("field residues are non-negative")
    digits = []
    while value:
        digits.append(value & 0xFFFFFFFF)
        value >>= 32
    return digits


def bincode_field_element(x: IntLike) -> bytes:
    """bincode(FieldElement) — the Merkle leaf encoding (reference:
    fri.rs:119, stark.rs:302)."""
    v = _value(x)
    digits = u32_digits(v)
    sign = _SIGN_NOSIGN if v == 0 else _SIGN_PLUS
    out = bytearray()
    out += sign.to_bytes(4, "little")
    out += len(digits).to_bytes(8, "little")
    for d in digits:
        out += d.to_bytes(4, "little")
    return bytes(out)


def bincode_string_vec(strings: Sequence[str]) -> bytes:
    """bincode(Vec<String>) — the proof-stream serialization
    (reference: proof_stream.rs:36-38)."""
    out = bytearray()
    out += len(strings).to_bytes(8, "little")
    for s in strings:
        b = s.encode("utf-8")
        out += len(b).to_bytes(8, "little")
        out += b
    return bytes(out)


def bincode_parse_string_vec(data: bytes) -> List[str]:
    """Inverse of :func:`bincode_string_vec`.

    Length fields are validated against the buffer size so malformed or
    hostile inputs fail fast instead of driving huge allocations/loops."""
    if len(data) < 8:
        raise ValueError("truncated proof stream header")
    n = int.from_bytes(data[0:8], "little")
    # each string costs at least 8 bytes (its length prefix)
    if 8 + 8 * n > len(data):
        raise ValueError("proof stream count exceeds buffer size")
    pos = 8
    out = []
    for _ in range(n):
        ln = int.from_bytes(data[pos : pos + 8], "little")
        pos += 8
        if pos + ln > len(data):
            raise ValueError("proof stream string overruns buffer")
        out.append(data[pos : pos + ln].decode("utf-8"))
        pos += ln
    if pos != len(data):
        raise ValueError("trailing bytes in proof stream")
    return out


# ---------------------------------------------------------------------------
# serde_json
# ---------------------------------------------------------------------------


def json_field_element(x: IntLike) -> str:
    """serde_json(FieldElement): {"value":["Plus",[...]]}"""
    v = _value(x)
    digits = u32_digits(v)
    sign = "NoSign" if v == 0 else "Plus"
    return '{"value":["%s",[%s]]}' % (sign, ",".join(str(d) for d in digits))


class MalformedProofData(ValueError):
    """Raised when transcript objects fail to parse.

    A subclass of ValueError so protocol-level error handling can treat
    every wire-format problem uniformly; raised for ANY structural issue
    (fuzzing showed e.g. a bit-flipped JSON int becoming a float and
    escaping as TypeError otherwise)."""


def _parse_guard(fn):
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except MalformedProofData:
            raise
        except (ValueError, TypeError, KeyError, IndexError, RecursionError) as exc:
            raise MalformedProofData(f"{fn.__name__}: {exc}") from exc

    return wrapper


@_parse_guard
def json_parse_field_element(s: str) -> FieldElement:
    obj = json.loads(s)
    return _field_element_from_obj(obj)


def _field_element_from_obj(obj) -> FieldElement:
    sign, digits = obj["value"]
    v = 0
    for i, d in enumerate(digits):
        # serde deserializes digits as u32: bools and out-of-range
        # numbers are type errors there, so they are rejections here
        if not isinstance(d, int) or isinstance(d, bool):
            raise MalformedProofData("non-integer digit")
        if not 0 <= d < (1 << 32):
            raise MalformedProofData("digit out of u32 range")
        v |= d << (32 * i)
    if sign == "Minus":
        v = -v
    return FieldElement(v)


def json_field_element_vec(xs: Sequence[IntLike]) -> str:
    """serde_json(Vec<FieldElement>) — e.g. the last FRI codeword
    (reference: fri.rs:146)."""
    return "[%s]" % ",".join(json_field_element(x) for x in xs)


@_parse_guard
def json_parse_field_element_vec(s: str) -> List[FieldElement]:
    return [_field_element_from_obj(o) for o in json.loads(s)]


def json_string_triple(a: str, b: str, c: str) -> str:
    """serde_json of a (String, String, String) tuple — FRI colinearity
    points (reference: fri.rs:169-178)."""
    return json.dumps((a, b, c), separators=(",", ":"))


@_parse_guard
def json_parse_string_triple(s: str) -> Tuple[str, str, str]:
    a, b, c = json.loads(s)
    if not all(isinstance(x, str) for x in (a, b, c)):
        raise MalformedProofData("triple entries must be strings")
    return a, b, c


def json_hash_path(path: Sequence[bytes]) -> str:
    """serde_json(Vec<GenericArray<u8, U32>>) — Merkle auth paths
    (reference: fri.rs:188-203).  Each digest renders as an array of 32
    integers."""
    return "[%s]" % ",".join(
        "[%s]" % ",".join(str(byte) for byte in digest) for digest in path
    )


@_parse_guard
def json_parse_hash_path(s: str) -> List[bytes]:
    out = []
    for arr in json.loads(s):
        digest = bytes(arr)
        if len(digest) != 32:
            # serde rejects GenericArray<u8, U32> of any other length —
            # accepting short digests here would be laxer than the
            # reference's deserializer (fri.rs:188-203)
            raise MalformedProofData("auth-path digest must be 32 bytes")
        out.append(digest)
    return out
