"""Host-side BLS12-381 group arithmetic (G1 over Fq, G2 over Fq2).

Small, correct Python-int implementations used for: SRS G2 elements, the
verifier's handful of scalar muls, serialization, and as the golden
reference for the batched device curve kernels
(:mod:`marlin_tpu_torch.ops.curve_device`).  Mirrors the slice of `ark-ec` the
reference consumes through `ark-poly-commit` (SURVEY.md §2b row 2).

Points are affine tuples `(x, y)` with `None` for the identity.
"""

from __future__ import annotations

from . import active as P
from . import host_pairing as hp

Q = P.Q_MODULUS


class _FieldOps:
    """Function table so the group law is written once for Fq and Fq2.

    `a` is the short-Weierstrass a-coefficient OF THE CURVE THIS TABLE
    SERVES: the base curve's a for Fq, the twist's a' for Fq2 (they differ
    whenever a != 0 — the MNT family; see curve_generic.GenericCurve)."""

    def __init__(self, add, sub, mul, sqr, inv, neg, zero, one, scalar, a):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.inv, self.neg, self.zero, self.one = inv, neg, zero, one
        self.scalar = scalar  # int -> field element
        self.a = a


FQ_OPS = _FieldOps(
    hp.fq_add, hp.fq_sub, hp.fq_mul, lambda a: a * a % Q,
    hp.fq_inv, hp.fq_neg, 0, 1, lambda s: s % Q,
    a=P.CURVE_A % Q,
)

FQ2_OPS = _FieldOps(
    hp.fq2_add, hp.fq2_sub, hp.fq2_mul, hp.fq2_sqr,
    hp.fq2_inv, hp.fq2_neg, hp.FQ2_ZERO, hp.FQ2_ONE, lambda s: (s % Q, 0),
    a=tuple(c % Q for c in getattr(P, "CURVE_A_TWIST", (0, 0))),
)


def _affine_add(f: _FieldOps, p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 != y2 or y1 == f.zero:
            return None
        # doubling: lam = (3 x^2 + a) / (2 y) — general short-Weierstrass a
        # taken from the ops table (base a for G1, twist a' for G2; the
        # MNT curve family has a != 0, BLS12/BN have a == 0)
        num = f.add(f.mul(f.scalar(3), f.sqr(x1)), f.a)
        lam = f.mul(num, f.inv(f.mul(f.scalar(2), y1)))
    else:
        lam = f.mul(f.sub(y2, y1), f.inv(f.sub(x2, x1)))
    x3 = f.sub(f.sub(f.sqr(lam), x1), x2)
    y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)
    return (x3, y3)


def _affine_neg(f: _FieldOps, p):
    return None if p is None else (p[0], f.neg(p[1]))


def _scalar_mul(f: _FieldOps, p, k: int):
    k %= P.R_MODULUS
    acc = None
    base = p
    while k:
        if k & 1:
            acc = _affine_add(f, acc, base)
        base = _affine_add(f, base, base)
        k >>= 1
    return acc


# --- G1 ----------------------------------------------------------------------

G1_GEN = (P.G1_GENERATOR_X, P.G1_GENERATOR_Y)


def g1_add(p, q):
    return _affine_add(FQ_OPS, p, q)


def g1_neg(p):
    return _affine_neg(FQ_OPS, p)


def g1_mul(p, k: int):
    """Scalar mul.  The affine ladder pays a field inversion per point op
    (ark-ec's AffineCurve::mul converts to projective for the same reason);
    with a == 0 the Jacobian ladder runs inversion-free and converts back
    once — ~25x fewer `pow(x, -1, q)` calls on the verifier's hot path.
    Routes through the native C runtime when built (~50x again)."""
    from . import native_curve as nc

    if nc.available():
        return nc.g1_mul(p, k)
    if _JAC_OK:
        if p is None:
            return None
        k %= P.R_MODULUS
        acc = (0, 1, 0)
        base = _jac_from_affine(p)
        while k:
            if k & 1:
                acc = _jac_add(acc, base)
            base = _jac_double(base)
            k >>= 1
        return _jac_to_affine(acc)
    return _scalar_mul(FQ_OPS, p, k)


def _mul_unreduced(f: _FieldOps, p, k: int):
    """Scalar mul WITHOUT reducing k mod r (for order checks, where
    [r]P = O is exactly the property being tested)."""
    acc = None
    base = p
    while k:
        if k & 1:
            acc = _affine_add(f, acc, base)
        base = _affine_add(f, base, base)
        k >>= 1
    return acc


def g1_in_subgroup(p) -> bool:
    """Prime-order subgroup membership: [r]P == O.  G1's cofactor is
    ~2^125, so on-curve does not imply in-subgroup."""
    return p is None or _mul_unreduced(FQ_OPS, p, P.R_MODULUS) is None


def g2_in_subgroup(p) -> bool:
    return p is None or _mul_unreduced(FQ2_OPS, p, P.R_MODULUS) is None


def g1_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + P.CURVE_A * x + P.CURVE_B)) % Q == 0


# --- host Jacobian arithmetic (no per-add inversions) ------------------------
# Used by the host MSM path; (X, Y, Z) with Z == 0 for identity.
# dbl-2009-l / add-2007-bl are a == 0 formulas (BLS12/BN); an a != 0 config
# (MNT family) must route through the affine law instead.
_JAC_OK = P.CURVE_A == 0


def _jac_double(p):
    assert _JAC_OK, "Jacobian fast path requires a == 0"
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return (0, 1, 0)
    A = X * X % Q
    B = Y * Y % Q
    C = B * B % Q
    D = 2 * ((X + B) * (X + B) - A - C) % Q
    E = 3 * A % Q
    X3 = (E * E - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y * Z % Q
    return (X3, Y3, Z3)


def _jac_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    if U1 == U2:
        if S1 != S2:
            return (0, 1, 0)
        return _jac_double(p)
    H = (U2 - U1) % Q
    I = 4 * H * H % Q
    J = H * I % Q
    r = 2 * (S2 - S1) % Q
    V = U1 * I % Q
    X3 = (r * r - J - 2 * V) % Q
    Y3 = (r * (V - X3) - 2 * S1 * J) % Q
    Z3 = (((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) % Q) * H % Q
    return (X3, Y3, Z3)


def _jac_from_affine(p):
    return (0, 1, 0) if p is None else (p[0], p[1], 1)


def _jac_to_affine(p):
    if p[2] == 0:
        return None
    zinv = pow(p[2], -1, Q)
    zinv2 = zinv * zinv % Q
    return (p[0] * zinv2 % Q, p[1] * zinv2 * zinv % Q)


def g1_fixed_base_powers(base, scalars, window: int = 8):
    """[s*base for s in scalars] via a shared windowed table (host).

    One-time SRS-style generation: W = ceil(255/c) table rows of 2^c
    multiples each; every scalar mul is then W-1 Jacobian adds.  Returns
    affine points (single batch inversion at the end).

    Production path is the native C library (csrc/marlin_curve.c, the
    ark-ec fixed-base analog); this Python body is its golden reference
    and the fallback when no C toolchain exists.
    """
    from . import native_curve as nc

    if nc.available():
        return nc.g1_fixed_base_powers(base, [s % P.R_MODULUS for s in scalars])
    c = window
    num_windows = -(-P.FR_BITS // c)
    base_j = _jac_from_affine(base)
    # table[w][d] = d * 2^(cw) * base
    table = []
    row_base = base_j
    for _ in range(num_windows):
        row = [(0, 1, 0)] * (1 << c)
        for d in range(1, 1 << c):
            row[d] = _jac_add(row[d - 1], row_base)
        table.append(row)
        for _ in range(c):
            row_base = _jac_double(row_base)
    mask = (1 << c) - 1
    out = []
    for s in scalars:
        s %= P.R_MODULUS
        acc = (0, 1, 0)
        w = 0
        while s:
            d = s & mask
            if d:
                acc = _jac_add(acc, table[w][d])
            s >>= c
            w += 1
        out.append(acc)
    # batched affine conversion: one field inversion for the whole batch
    zs = [p[2] for p in out]
    nonzero = [z for z in zs if z != 0]
    # prefix-product inversion
    prefix = []
    acc = 1
    for z in nonzero:
        acc = acc * z % Q
        prefix.append(acc)
    inv_all = pow(acc, -1, Q) if nonzero else 1
    invs = [0] * len(nonzero)
    for i in range(len(nonzero) - 1, -1, -1):
        before = prefix[i - 1] if i > 0 else 1
        invs[i] = inv_all * before % Q
        inv_all = inv_all * nonzero[i] % Q
    result = []
    k = 0
    for p in out:
        if p[2] == 0:
            result.append(None)
            continue
        zi = invs[k]
        k += 1
        zi2 = zi * zi % Q
        result.append((p[0] * zi2 % Q, p[1] * zi2 * zi % Q))
    return result


def g1_msm(points, scalars, window: int = 8):
    """Host Pippenger MSM with Jacobian buckets.

    The host fallback for small commitment batches; the production path is
    ops/msm.py on device.  Routes through the native C library when built.
    """
    from . import native_curve as nc

    if nc.available():
        clean = [(p, s) for p, s in zip(points, scalars)]
        return nc.g1_msm([p for p, _ in clean], [s for _, s in clean])
    pairs = [
        (_jac_from_affine(p), s % P.R_MODULUS)
        for p, s in zip(points, scalars)
        if p is not None and s % P.R_MODULUS != 0
    ]
    if not pairs:
        return None
    c = window
    num_windows = -(-P.FR_BITS // c)
    total = (0, 1, 0)
    for w in range(num_windows - 1, -1, -1):
        for _ in range(c if w != num_windows - 1 else 0):
            total = _jac_double(total)
        buckets = [(0, 1, 0)] * ((1 << c) - 1)
        shift = w * c
        mask = (1 << c) - 1
        for pt, s in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d - 1] = _jac_add(buckets[d - 1], pt)
        running = (0, 1, 0)
        acc = (0, 1, 0)
        for b in range(len(buckets) - 1, -1, -1):
            running = _jac_add(running, buckets[b])
            acc = _jac_add(acc, running)
        total = _jac_add(total, acc)
    return _jac_to_affine(total)


# --- G2 ----------------------------------------------------------------------

G2_GEN = (P.G2_GENERATOR_X, P.G2_GENERATOR_Y)


def g2_add(p, q):
    return _affine_add(FQ2_OPS, p, q)


def g2_neg(p):
    return _affine_neg(FQ2_OPS, p)


def g2_mul(p, k: int):
    from . import native_curve as nc

    if nc.available():
        return nc.g2_mul(p, k)
    return _scalar_mul(FQ2_OPS, p, k)


def g2_fixed_base_powers(base, scalars):
    """[s*base] over G2 (native C fast path; per-scalar ladder fallback).

    Feeds the Sonic SRS's negative powers of tau in G2 (ark sonic_pc
    setup emits these so the trapdoor never outlives the ceremony).
    """
    from . import native_curve as nc

    if nc.available():
        return nc.g2_fixed_base_powers(base, [s % P.R_MODULUS for s in scalars])
    return [g2_mul(base, s) for s in scalars]


def g2_is_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    # y^2 = x^3 + a'x + b' on the twist (a' from the ops table; zero for
    # all BLS12/BN curves, nonzero for the MNT family)
    rhs = hp.fq2_add(hp.fq2_mul(hp.fq2_sqr(x), x), (P.CURVE_B_TWIST[0], P.CURVE_B_TWIST[1]))
    if FQ2_OPS.a != hp.FQ2_ZERO:
        rhs = hp.fq2_add(rhs, hp.fq2_mul(FQ2_OPS.a, x))
    return hp.fq2_sqr(y) == rhs


# --- Serialization -----------------------------------------------------------
# Layout follows ark-serialize 0.3's short-Weierstrass compressed encoding:
# little-endian x with flag bits in the top byte (bit7 = y is the
# lexicographically larger root, bit6 = infinity).

_FLAG_Y_LARGEST = 1 << 7
_FLAG_INFINITY = 1 << 6


def g1_compress(p) -> bytes:
    if p is None:
        b = bytearray(P.FQ_BYTES)
        b[-1] |= _FLAG_INFINITY
        return bytes(b)
    x, y = p
    b = bytearray(int(x).to_bytes(P.FQ_BYTES, "little"))
    if y > Q - y:
        b[-1] |= _FLAG_Y_LARGEST
    return bytes(b)


def _sqrt_mod(a: int):
    """Square root mod q, or None: q ≡ 3 (mod 4) fast path (BLS12-381,
    BN254) with Tonelli-Shanks for q ≡ 1 (mod 4) fields (BLS12-377)."""
    a %= Q
    if a == 0:
        return 0
    if Q % 4 == 3:
        y = pow(a, (Q + 1) // 4, Q)
        return y if y * y % Q == a else None
    if pow(a, (Q - 1) // 2, Q) != 1:
        return None
    qq, s = Q - 1, 0
    while qq % 2 == 0:
        qq //= 2
        s += 1
    z = 2
    while pow(z, (Q - 1) // 2, Q) == 1:
        z += 1
    m, c, t, r = s, pow(z, qq, Q), pow(a, qq, Q), pow(a, (qq + 1) // 2, Q)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = t2 * t2 % Q
            i += 1
        b = pow(c, 1 << (m - i - 1), Q)
        m, c = i, b * b % Q
        t, r = t * c % Q, r * b % Q
    return r


def g1_decompress(b: bytes):
    """Inverse of g1_compress with full validation: coordinate range,
    on-curve, and prime-order-subgroup membership (ark
    CanonicalDeserialize::deserialize performs the same checks; G1's
    cofactor is nontrivial so on-curve alone does not imply subgroup)."""
    b = bytearray(b)
    flags = b[-1] & 0xC0
    b[-1] &= 0x3F
    if flags & _FLAG_INFINITY:
        return None
    x = int.from_bytes(bytes(b), "little")
    if x >= Q:
        raise ValueError("x coordinate out of field range")
    y2 = (x * x * x + P.CURVE_A * x + P.CURVE_B) % Q
    y = _sqrt_mod(y2)
    if y is None:
        raise ValueError("not a point on the curve")
    if (y > Q - y) != bool(flags & _FLAG_Y_LARGEST):
        y = Q - y
    p = (x, y)
    if not g1_in_subgroup(p):
        raise ValueError("point not in the prime-order subgroup")
    return p


def g2_compress(p) -> bytes:
    if p is None:
        b = bytearray(2 * P.FQ_BYTES)
        b[-1] |= _FLAG_INFINITY
        return bytes(b)
    (x0, x1), (y0, y1) = p
    # c0 first then c1, matching arkworks QuadExtField serialization.
    b = bytearray(int(x0).to_bytes(P.FQ_BYTES, "little") + int(x1).to_bytes(P.FQ_BYTES, "little"))
    if (y1, y0) > ((Q - y1) % Q, (Q - y0) % Q):
        b[-1] |= _FLAG_Y_LARGEST
    return bytes(b)


def g1_to_bytes(p) -> bytes:
    """ark-ff `ToBytes` layout for affine points: x || y || infinity byte."""
    if p is None:
        return bytes(2 * P.FQ_BYTES) + b"\x01"
    return (
        int(p[0]).to_bytes(P.FQ_BYTES, "little")
        + int(p[1]).to_bytes(P.FQ_BYTES, "little")
        + b"\x00"
    )


def g2_to_bytes(p) -> bytes:
    if p is None:
        return bytes(4 * P.FQ_BYTES) + b"\x01"
    (x0, x1), (y0, y1) = p
    out = b"".join(int(v).to_bytes(P.FQ_BYTES, "little") for v in (x0, x1, y0, y1))
    return out + b"\x00"
