"""Base-field (Fq) arithmetic on tensors, for the active curve.

Elements are `[.., L]` int32 tensors of 16-bit limbs in Montgomery form,
R = 2^(16 L), with L from the curve's config: 24 (R = 2^384) for
BLS12-381, BLS12-377 and synthetic_lowadic, 16 (R = 2^256) for BN254.  The
elementwise ops route by device like ops/fr.py; the curve layer
(ops/curve_device.py) holds points in this layout.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import active as P
from . import bigint as bi
from . import routing as _routing
from .limbs import int_to_limbs, ints_to_limbs, limbs_to_ints

# 16-bit limbs: FQ_BYTES of the curve's config (48 or 32 bytes)
CTX = bi.ModCtx("fq", P.Q_MODULUS, P.FQ_BYTES * 8 // 16, P.CURVE_NAME)
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


def zeros(shape=(), device="cpu"):
    return bi.zeros(CTX, shape, device)


def ones(shape=(), device="cpu"):
    return CTX.const("one", device).expand(*shape, L).clone()


def from_ints(xs, device) -> torch.Tensor:
    mont = [x * P.FQ_MONT_R % P.Q_MODULUS for x in xs]
    limbs = ints_to_limbs(mont, L).reshape(len(mont), L)
    return torch.as_tensor(limbs.astype(np.int32), device=device)


def from_int(x: int, device) -> torch.Tensor:
    limbs = int_to_limbs(x * P.FQ_MONT_R % P.Q_MODULUS, L)
    return torch.as_tensor(limbs.astype(np.int32), device=device)


def to_ints(arr) -> list[int]:
    rinv = pow(P.FQ_MONT_R, -1, P.Q_MODULUS)
    host = arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return [x * rinv % P.Q_MODULUS for x in limbs_to_ints(host)]


def to_int(arr) -> int:
    return to_ints(arr.reshape(1, -1))[0]
