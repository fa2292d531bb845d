"""Limb-vector representation of big integers.

Field elements are `[..., L]` arrays of base-2^16 limbs, least-significant
first — the layout of the JAX package, kept at this package's API so the
two compare limb for limb.  L comes from the curve's config: Fr
(254-255 bits) uses L=16 (R = 2^256); Fq uses L=24 (R = 2^384) for the
377-381-bit moduli and L=16 for BN254's 254-bit one.  Torch tensors store the limbs as int32
(`LIMB_DTYPE`); the helpers here build numpy arrays from Python ints.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, L: int) -> np.ndarray:
    """Non-negative int -> [L] uint32 base-2^16 limbs (LSB first)."""
    b = int(x).to_bytes(2 * L, "little")
    return np.frombuffer(b, dtype="<u2").astype(np.uint32)


def limbs_to_int(limbs) -> int:
    """[L] limbs -> int.  Accepts redundant (unnormalized) limbs."""
    arr = np.asarray(limbs)
    acc = 0
    for i in range(arr.shape[-1] - 1, -1, -1):
        acc = (acc << LIMB_BITS) + int(arr[i])
    return acc


def ints_to_limbs(xs, L: int) -> np.ndarray:
    """Iterable of ints -> [n, L] uint32 (bulk, via byte packing)."""
    xs = list(xs)
    buf = b"".join(int(x).to_bytes(2 * L, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u2").reshape(len(xs), L).astype(np.uint32)


def limbs_to_ints(arr) -> list[int]:
    """[n, L] normalized (16-bit) limbs -> list of ints (bulk)."""
    arr = np.asarray(arr)
    flat = arr.reshape(-1, arr.shape[-1])
    if flat.size and flat.max() <= LIMB_MASK and flat.min() >= 0:
        packed = flat.astype("<u2").tobytes()
        w = 2 * flat.shape[1]
        return [int.from_bytes(packed[i * w : (i + 1) * w], "little") for i in range(flat.shape[0])]
    return [limbs_to_int(row) for row in flat]
