"""Scalar-field (Fr) arithmetic on tensors, for the active curve.

Binds the limb machinery of ops/bigint.py to the Fr modulus.  Elements are
`[.., L]` int32 tensors of 16-bit limbs in Montgomery form (L = 16; 48 for
test_wide750).  The elementwise ops route by device (ops/routing.py): a
CUDA tensor launches the field kernels of csrc/field.cu, a CPU tensor runs
the plain version.
Functions that build tensors from host values take an explicit `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import active as P
from . import bigint as bi
from . import routing as _routing
from .limbs import int_to_limbs, ints_to_limbs, limbs_to_ints

# limb count tracks the config's Montgomery radix (R = 2^(8*FR_BYTES))
CTX = bi.ModCtx("fr", P.R_MODULUS, P.FR_BYTES * 8 // 16, P.CURVE_NAME)
L = CTX.L


def add(a, b):
    return _routing.binop("add", CTX, a, b)


def sub(a, b):
    return _routing.binop("sub", CTX, a, b)


def mul(a, b):
    return _routing.binop("mul", CTX, a, b)


def sqr(a):
    return mul(a, a)


def inv(a):
    return _routing.inv(CTX, a)


def neg(a):
    return sub(torch.zeros_like(a), a)


def is_zero(a):
    return bi.is_zero(CTX, a)


def eq(a, b):
    return bi.eq(CTX, a, b)


def select(c, a, b):
    return bi.select(c, a, b)


def modsum(a, dim: int = 0):
    return bi.modsum(CTX, a, dim)


def reduce_wide(t):
    return bi.reduce_wide(CTX, t)


def zeros(shape=(), device="cpu"):
    return bi.zeros(CTX, shape, device)


def ones(shape=(), device="cpu"):
    return CTX.const("one", device).expand(*shape, L).clone()


def pow_const(x, e: int):
    """x^e (Montgomery in/out) for a static exponent e >= 0."""
    nbits = max(e.bit_length(), 1)
    return _routing.pow_const(CTX, x, [(e >> (nbits - 1 - i)) & 1 for i in range(nbits)])


# --- host <-> device conversions (Montgomery form on device) ----------------


def _tensor(limbs: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(limbs, dtype=np.int32), device=device)


def from_ints(xs, device) -> torch.Tensor:
    """Canonical ints -> Montgomery limbs [n, L]."""
    mont = [x * P.FR_MONT_R % P.R_MODULUS for x in xs]
    return _tensor(ints_to_limbs(mont, L).reshape(len(mont), L), device)


def from_canonical_limbs(limbs, device) -> torch.Tensor:
    """[n, L] canonical limb rows (e.g. ZkRng.rand_fr_limbs) -> Montgomery
    limbs, with the R-multiplication on the device."""
    return bi.to_mont(CTX, _tensor(np.asarray(limbs), device))


def from_ints_via_device(xs, device) -> torch.Tensor:
    """Like from_ints but with the Montgomery conversion on the device."""
    xs = [x % P.R_MODULUS for x in xs]
    return from_canonical_limbs(ints_to_limbs(xs, L).reshape(len(xs), L), device)


def from_int(x: int, device) -> torch.Tensor:
    return _tensor(int_to_limbs(x * P.FR_MONT_R % P.R_MODULUS, L), device)


def to_ints(arr) -> list[int]:
    """Montgomery limbs -> canonical ints (host)."""
    rinv = pow(P.FR_MONT_R, -1, P.R_MODULUS)
    host = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return [x * rinv % P.R_MODULUS for x in limbs_to_ints(host)]


def to_int(arr) -> int:
    return to_ints(arr.reshape(1, -1))[0]
