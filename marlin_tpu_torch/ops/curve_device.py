"""G1 point batches of the active curve as tensors (Jacobian over Fq limbs).

Port of `marlin_tpu/ops/curve_device.py`.  A point batch is a tuple
(X, Y, Z) of `[.., fq.L]` Fq Montgomery limb tensors (24 limbs, 16 for
BN254), identity <=> Z == 0.
`add`, `double` and `scalar_mul_batch` are kernel 4 on a CUDA tensor and
its plain version on a CPU tensor (ops/curve.py); the field ops route the same way
(ops/routing.py).  Every edge case is resolved per lane, so one launch
serves a whole batch.
"""

from __future__ import annotations

import torch

from ..fields import active as P
from . import curve, fq

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


def is_identity(p: Point) -> torch.Tensor:
    return (p[2] == 0).all(-1)


def negate(p: Point) -> Point:
    return (p[0], fq.neg(p[1]), p[2])


def select_point(cond: torch.Tensor, a: Point, b: Point) -> Point:
    return tuple(torch.where(cond[..., None], a[i], b[i]) for i in range(3))


def add(p: Point, q: Point) -> Point:
    """Complete Jacobian add (add-2007-bl with its edge cases), broadcasting."""
    return curve.add(p, q)


def double(p: Point) -> Point:
    """Jacobian doubling, a = 0 (dbl-2009-l); Y = 0 or Z = 0 -> identity."""
    return curve.double(p)


def tree_reduce_add(p: Point) -> Point:
    """Sum over the leading axis of a [n, ...] point batch -> [1, ...].

    Fan-in-16 levels as in the JAX package: each level pads with the
    identity to a multiple of 16 and folds the 16 columns in order, so the
    Jacobian result is the reference's."""
    FAN = 16
    n = p[0].shape[0]
    while n > 1:
        pad = -n % FAN
        if pad:
            ident = identity((pad, *p[0].shape[1:-1]), p[0].device)
            p = tuple(torch.cat([p[i], ident[i]]) for i in range(3))
            n += pad
        m = n // FAN
        cols = tuple(c.reshape(m, FAN, *c.shape[1:]) for c in p)
        acc = tuple(c[:, 0] for c in cols)
        for j in range(1, FAN):
            acc = add(acc, tuple(c[:, j] for c in cols))
        p = acc
        n = m
    return p


def normalize_batch(p: Point) -> Point:
    """Jacobian -> affine form (Z in {0, 1}): one Fq inversion per point
    (kernel 2 on the card; 0 maps to 0) and three products."""
    X, Y, Z = p
    zinv = fq.inv(Z)
    zinv2 = fq.mul(zinv, zinv)
    x = fq.mul(X, zinv2)
    y = fq.mul(Y, fq.mul(zinv2, zinv))
    inf = (Z == 0).all(-1, keepdim=True)
    one = fq.ones(Z.shape[:-1], Z.device)
    zero = torch.zeros_like(Z)
    return (torch.where(inf, zero, x), torch.where(inf, one, y), torch.where(inf, zero, one))


def scalar_mul_batch(points: Point, scalar_limbs: torch.Tensor, num_bits: int = 255) -> Point:
    """Elementwise s_i * P_i (double-and-add, MSB first): one launch of
    kernel 4's ladder on the card (ops/curve.py::scalar_mul).

    scalar_limbs: [..., 16] canonical (not Montgomery) base-2^16 Fr limbs,
    broadcast against the points."""
    return curve.scalar_mul(points, scalar_limbs, num_bits)


def to_affine_ints(pt: Point) -> list:
    """Point batch -> list of affine (x, y) tuples / None, normalized on the
    point's device."""
    x, y, _ = normalize_batch(pt)
    inf = is_identity(pt).reshape(-1).tolist()
    return [None if i else (a, b) for a, b, i in zip(fq.to_ints(x), fq.to_ints(y), inf)]
