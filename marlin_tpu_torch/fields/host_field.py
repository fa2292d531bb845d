"""Host-side (CPU, arbitrary-precision) prime-field arithmetic.

This is the golden-reference layer: small, obviously-correct Python-int
implementations of the field operations the device kernels implement in limb
form.  It is used for (a) cross-checking device kernels in tests, (b) the
succinct verifier's scalar work (which the reference also keeps tiny:
src/lib.rs:315-433 is O(|x| + log) field ops plus pairings), and (c)
serialization codecs.

Mirrors the capability surface of `ark-ff` (SURVEY.md §2b row 1).
"""

from __future__ import annotations

from . import active as P


def fr_add(a: int, b: int) -> int:
    c = a + b
    return c - P.R_MODULUS if c >= P.R_MODULUS else c


def fr_sub(a: int, b: int) -> int:
    c = a - b
    return c + P.R_MODULUS if c < 0 else c


def fr_mul(a: int, b: int) -> int:
    return a * b % P.R_MODULUS


def fr_neg(a: int) -> int:
    return (-a) % P.R_MODULUS


def fr_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(a, -1, P.R_MODULUS)


def fr_pow(a: int, e: int) -> int:
    return pow(a, e, P.R_MODULUS)


def batch_inversion(elems: list[int], modulus: int = P.R_MODULUS) -> list[int]:
    """Montgomery batch-inversion trick (zero entries stay zero).

    Semantics follow ark_ff::batch_inversion (call sites:
    reference src/ahp/constraint_systems.rs:194, src/ahp/prover.rs:663,
    src/ahp/mod.rs:314): zeros are skipped, nonzero entries inverted.
    """
    prod = []
    acc = 1
    for e in elems:
        if e != 0:
            acc = acc * e % modulus
        prod.append(acc)
    acc = pow(acc, -1, modulus)
    out = list(elems)
    for i in range(len(elems) - 1, -1, -1):
        if elems[i] == 0:
            continue
        before = prod[i - 1] if i > 0 else 1
        # find previous nonzero prefix
        j = i - 1
        while j >= 0 and elems[j] == 0:
            j -= 1
        before = prod[j] if j >= 0 else 1
        out[i] = acc * before % modulus
        acc = acc * elems[i] % modulus
    return out


# --- byte codecs (arkworks-compatible layout) -------------------------------


def fr_to_bytes(a: int) -> bytes:
    """ark-ff `ToBytes`: canonical little-endian, full 32-byte repr."""
    return int(a).to_bytes(P.FR_BYTES, "little")


def fr_from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little")


def fq_to_bytes(a: int) -> bytes:
    return int(a).to_bytes(P.FQ_BYTES, "little")


def fq_from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little")


def u64_to_bytes(v: int) -> bytes:
    return int(v).to_bytes(8, "little")
