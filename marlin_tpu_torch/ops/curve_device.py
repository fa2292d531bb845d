"""BLS12-381 G1 point batches as tensors (Jacobian over Fq limbs).

Port of the part of `marlin_tpu/ops/curve_device.py` that the host MSM
route needs: the `Point` layout — a tuple (X, Y, Z) of `[.., 24]` Fq
Montgomery limb tensors, identity <=> Z == 0 — and the conversions between
it and affine int tuples.  The device group law (`add`, `double`,
`scalar_mul_batch`, `tree_reduce_add`) comes with its kernels in a later
slice of the port.
"""

from __future__ import annotations

import torch

from ..fields import active as P
from . import fq

Point = tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (X, Y, Z) Jacobian


def from_affine_ints(points: list, device) -> Point:
    """List of affine (x, y) int tuples (None = identity) -> point batch."""
    xs, ys, zs = [], [], []
    for p in points:
        if p is None:
            xs.append(0)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(p[0])
            ys.append(p[1])
            zs.append(1)
    return (fq.from_ints(xs, device), fq.from_ints(ys, device), fq.from_ints(zs, device))


def to_affine_ints_host(pt: Point) -> list:
    """Point batch -> list of affine (x, y) tuples / None, normalized on the
    host: the raw Jacobian limbs transfer and the Z inversions collapse into
    one modular inverse (prefix-product trick in host ints)."""
    x_raw, y_raw, z_raw = (c.detach().cpu().numpy() for c in pt)
    return affine_ints_from_raw(x_raw, y_raw, z_raw)


def affine_ints_from_raw(x_raw, y_raw, z_raw) -> list:
    """Host-side tail of to_affine_ints_host over fetched limb arrays."""
    q = P.Q_MODULUS
    xs = fq.to_ints(x_raw)
    ys = fq.to_ints(y_raw)
    zs = fq.to_ints(z_raw)
    nonzero = [z for z in zs if z != 0]
    if not nonzero:
        return [None] * len(zs)
    prefix = []
    acc = 1
    for z in nonzero:
        acc = acc * z % q
        prefix.append(acc)
    inv_all = pow(acc, -1, q)
    invs = [0] * len(nonzero)
    for i in range(len(nonzero) - 1, -1, -1):
        invs[i] = inv_all * (prefix[i - 1] if i else 1) % q
        inv_all = inv_all * nonzero[i] % q
    out = []
    k = 0
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
            continue
        zi = invs[k]
        k += 1
        zi2 = zi * zi % q
        out.append((x * zi2 % q, y * zi2 % q * zi % q))
    return out


def identity(shape=(), device="cpu") -> Point:
    return (fq.zeros(shape, device), fq.ones(shape, device), fq.zeros(shape, device))


def gather(p: Point, idx: torch.Tensor) -> Point:
    return (p[0][idx], p[1][idx], p[2][idx])
