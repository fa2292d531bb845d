"""BLS12-381 pairing on the host.

The reference reaches pairings only through `PC::check_combinations`
(reference src/lib.rs:413-423) — the verifier is succinct, so pairings are
off the device critical path (SURVEY.md §7 step 6).  This module implements the
tower Fq2/Fq6/Fq12, the ate Miller loop, and the final exponentiation with
plain Python integers.

Tower (matching arkworks' construction for BLS12-381):
    Fq2  = Fq [u] / (u^2 + 1)
    Fq6  = Fq2[v] / (v^3 - xi),  xi = u + 1
    Fq12 = Fq6[w] / (w^2 - v)           (so w^6 = xi)

G2 points live on the M-twist E': y^2 = x^3 + 4*xi and are mapped into
E(Fq12) via psi(x, y) = (x * w^-2, y * w^-3) for the Miller loop.  The loop
is the straightforward affine version with explicit Fq12 slopes; correctness
is established by bilinearity tests rather than trusting sparse-mul index
conventions.
"""

from __future__ import annotations

from . import active as P

Q = P.Q_MODULUS

# --- Fq ---------------------------------------------------------------------

def fq_add(a, b):
    return (a + b) % Q


def fq_sub(a, b):
    return (a - b) % Q


def fq_mul(a, b):
    return a * b % Q


def fq_inv(a):
    return pow(a, -1, Q)


def fq_neg(a):
    return (-a) % Q


# --- Fq2: (c0, c1) = c0 + c1*u, u^2 = NR -------------------------------------
# NR comes from the active config (-1 for BLS12-381/BN254, -5 for
# BLS12-377); this layer also backs host_curve's G2 group law, so it must
# be non-residue-generic even though the tower above it is BLS-only.

# kept as a small signed int so nr*t stays a cheap bigint-by-word product
_NR = getattr(P, "FQ2_NONRESIDUE", -1)
assert abs(_NR) < 1 << 20, "FQ2_NONRESIDUE expected as a small signed int"

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    # Karatsuba: 3 base muls instead of 4
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    return ((t0 + _NR * t1) % Q, ((a0 + a1) * (b0 + b1) - t0 - t1) % Q)


if _NR == -1:

    def fq2_sqr(a):
        # complex method: 2 base muls (u^2 = -1 only)
        a0, a1 = a
        return ((a0 + a1) * (a0 - a1) % Q, 2 * a0 * a1 % Q)

else:

    def fq2_sqr(a):
        a0, a1 = a
        return ((a0 * a0 + _NR * a1 * a1) % Q, 2 * a0 * a1 % Q)


def fq2_mul_scalar(a, s):
    return (a[0] * s % Q, a[1] * s % Q)


def fq2_inv(a):
    a0, a1 = a
    norm = (a0 * a0 - _NR * a1 * a1) % Q
    ninv = pow(norm, -1, Q)
    return (a0 * ninv % Q, (-a1 * ninv) % Q)


def fq2_conj(a):
    return (a[0], (-a[1]) % Q)


def fq2_mul_by_xi(a):
    """Multiply by the Fq6 non-residue xi = u + 1."""
    a0, a1 = a
    return ((a0 - a1) % Q, (a0 + a1) % Q)


# --- Fq6: triples of Fq2, v^3 = xi -------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return tuple(fq2_add(x, y) for x, y in zip(a, b))


def fq6_sub(a, b):
    return tuple(fq2_sub(x, y) for x, y in zip(a, b))


def fq6_neg(a):
    return tuple(fq2_neg(x) for x in a)


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    # Karatsuba-style cross terms
    c0 = fq2_add(t0, fq2_mul_by_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), fq2_mul_by_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sqr(a):
    # CH-SQR2: 3 Fq2 squarings + 2 Fq2 muls (vs 6 muls via fq6_mul)
    a0, a1, a2 = a
    s0 = fq2_sqr(a0)
    s1 = fq2_mul(a0, a1)
    s1 = fq2_add(s1, s1)
    s2 = fq2_sqr(fq2_add(fq2_sub(a0, a1), a2))
    s3 = fq2_mul(a1, a2)
    s3 = fq2_add(s3, s3)
    s4 = fq2_sqr(a2)
    c0 = fq2_add(s0, fq2_mul_by_xi(s3))
    c1 = fq2_add(s1, fq2_mul_by_xi(s4))
    c2 = fq2_sub(fq2_sub(fq2_add(fq2_add(s1, s2), s3), s0), s4)
    return (c0, c1, c2)


def fq6_mul_by_v(a):
    """Multiply by v (shifts coefficients; v^3 = xi)."""
    a0, a1, a2 = a
    return (fq2_mul_by_xi(a2), a0, a1)


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sqr(a0), fq2_mul_by_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_by_xi(fq2_sqr(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sqr(a1), fq2_mul(a0, a2))
    t = fq2_add(fq2_mul_by_xi(fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))), fq2_mul(a0, c0))
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


# --- Fq12: pairs of Fq6, w^2 = v ---------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)
FQ12_W = (FQ6_ZERO, FQ6_ONE)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_neg(a):
    return (fq6_neg(a[0]), fq6_neg(a[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), fq6_add(t0, t1))
    return (c0, c1)


def fq12_sqr(a):
    # complex method over Fq6: 2 Fq6 muls instead of 3
    a0, a1 = a
    v0 = fq6_mul(a0, a1)
    t = fq6_mul(fq6_add(a0, a1), fq6_add(a0, fq6_mul_by_v(a1)))
    c0 = fq6_sub(fq6_sub(t, v0), fq6_mul_by_v(v0))
    c1 = fq6_add(v0, v0)
    return (c0, c1)


def fq12_inv(a):
    a0, a1 = a
    norm = fq6_sub(fq6_sqr(a0), fq6_mul_by_v(fq6_sqr(a1)))
    ninv = fq6_inv(norm)
    return (fq6_mul(a0, ninv), fq6_neg(fq6_mul(a1, ninv)))


def fq12_conj(a):
    """Conjugation = Frobenius^6 (negates the w-part)."""
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e: int):
    if e < 0:
        a = fq12_inv(a)
        e = -e
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sqr(base)
        e >>= 1
    return result


def fq12_eq(a, b):
    return a == b


def fq_to_fq12(a: int):
    return (((a % Q, 0), FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


def fq2_to_fq12(a):
    return ((a, FQ2_ZERO, FQ2_ZERO), FQ6_ZERO)


# w^-2 and w^-3, used by the twist embedding psi.
_W_INV = fq12_inv(FQ12_W)
_W_INV2 = fq12_sqr(_W_INV)
_W_INV3 = fq12_mul(_W_INV2, _W_INV)


def psi(q_point):
    """Map an affine G2 point on the M-twist into E(Fq12)."""
    x, y = q_point
    return (fq12_mul(fq2_to_fq12(x), _W_INV2), fq12_mul(fq2_to_fq12(y), _W_INV3))


# --- Miller loop / pairing ---------------------------------------------------

# Exponent of the final exponentiation, as a raw integer.  Slow-but-sure:
# optimized cyclotomic chains can land later without changing results.
FINAL_EXP = (Q**12 - 1) // P.R_MODULUS


def _line(t, s, p):
    """Evaluate the line through Fq12 points t, s at p=(xp, yp) in Fq12.

    Handles t == s (tangent).  Points must not be at infinity and
    t != -s (never happens inside the ate loop for r-torsion inputs).
    """
    (xt, yt), (xs, ys) = t, s
    if xt == xs and yt == ys:
        # tangent: lambda = 3 x^2 / (2 y)
        num = fq12_mul(fq_to_fq12(3), fq12_sqr(xt))
        den = fq12_mul(fq_to_fq12(2), yt)
    else:
        num = fq12_sub(ys, yt)
        den = fq12_sub(xs, xt)
    lam = fq12_mul(num, fq12_inv(den))
    xp, yp = p
    # l(P) = yP - yT - lam * (xP - xT)
    l = fq12_sub(fq12_sub(yp, yt), fq12_mul(lam, fq12_sub(xp, xt)))
    # chord-and-tangent output point
    x3 = fq12_sub(fq12_sub(fq12_sqr(lam), xt), xs)
    y3 = fq12_sub(fq12_mul(lam, fq12_sub(xt, x3)), yt)
    return l, (x3, y3)


def _sparse_line(lam, t, p_affine):
    """Line through psi-images with twist slope `lam`, evaluated at P,
    scaled by the Fq2 unit xi (killed by the easy final exponentiation).

    With the M-twist embedding psi(x, y) = (x w^-2, y w^-3), the line
    through psi(T) with twist-coordinate slope lam has Fq12 slope lam/w,
    so  l(P) = yP - lam*xP*w^-1 + (lam*xT - yT)*w^-3.  Using w^6 = xi:
    xi*l(P) = yP*xi + (lam*xT - yT)*w^3 - lam*xP*w^5 — three nonzero Fq2
    slots (w^0, w^3, w^5) in the tower basis c_{j,i} <-> w^(2i+j):
    (0,0), (1,1), (2,1)."""
    xt, yt = t
    xp, yp = p_affine
    a = fq2_mul_scalar(_XI, yp)
    b = fq2_sub(fq2_mul(lam, xt), yt)
    c = fq2_mul_scalar(lam, (-xp) % Q)
    return a, b, c


def _mul_by_sparse(f, a, b, c):
    """f * ((a,0,0),(0,b,c)) — dense Fq12 times a w^0/w^3/w^5 sparse line."""
    f0, f1 = f
    a6 = (a, FQ2_ZERO, FQ2_ZERO)
    bc6 = (FQ2_ZERO, b, c)
    t0 = tuple(fq2_mul(x, a) for x in f0)  # f0 * a
    t1 = fq6_mul(f1, bc6)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    # (f0 + f1) * (a6 + bc6) - t0 - t1
    s = fq6_mul(fq6_add(f0, f1), fq6_add(a6, bc6))
    c1 = fq6_sub(fq6_sub(s, t0), t1)
    return (c0, c1)


def miller_loop(p_affine, q_affine):
    """f_{|x|, psi(Q)}(P) for the ate pairing, conjugated for negative x.

    p_affine: (x, y) ints on G1, or None for infinity.
    q_affine: ((x0,x1), (y0,y1)) Fq2 pairs on the twist, or None.

    Group arithmetic runs in twist (Fq2) coordinates — one cheap Fq2
    inversion per step instead of an Fq12 inversion — and each line lands
    as a 3-slot sparse Fq12 product (`_sparse_line`/`_mul_by_sparse`).
    Per-line Fq2-unit scale factors are annihilated by the easy part of
    the final exponentiation, so pairing outputs are unchanged.
    """
    if p_affine is None or q_affine is None:
        return FQ12_ONE
    t = q_affine
    f = FQ12_ONE
    bits = bin(P.BLS_X)[3:]  # skip leading 1
    for bit in bits:
        xt, yt = t
        lam = fq2_mul(
            fq2_mul_scalar(fq2_sqr(xt), 3),
            fq2_inv(fq2_mul_scalar(yt, 2)),
        )
        a, b, c = _sparse_line(lam, t, p_affine)
        x3 = fq2_sub(fq2_sqr(lam), fq2_mul_scalar(xt, 2))
        y3 = fq2_sub(fq2_mul(lam, fq2_sub(xt, x3)), yt)
        t = (x3, y3)
        f = _mul_by_sparse(fq12_sqr(f), a, b, c)
        if bit == "1":
            xq, yq = q_affine
            xt, yt = t
            lam = fq2_mul(fq2_sub(yq, yt), fq2_inv(fq2_sub(xq, xt)))
            a, b, c = _sparse_line(lam, t, p_affine)
            x3 = fq2_sub(fq2_sub(fq2_sqr(lam), xt), xq)
            y3 = fq2_sub(fq2_mul(lam, fq2_sub(xt, x3)), yt)
            t = (x3, y3)
            f = _mul_by_sparse(f, a, b, c)
    if P.BLS_X_IS_NEGATIVE:
        f = fq12_conj(f)
    return f


# --- Frobenius endomorphism on Fq12 ------------------------------------------
# v^q = v * xi^((q-1)/3), w^q = w * xi^((q-1)/6) (3, 6 | q-1 for BLS12-381),
# and the q-power map conjugates Fq2 coefficients.  For
# x = sum_j w^j sum_i c_{ji} v^i:  frob(x)_{ji} = conj(c_{ji}) * gamma[j][i]
# with gamma[j][i] = (xi^((q-1)/3))^i * (xi^((q-1)/6))^j.


def fq2_pow(a, e: int):
    r = FQ2_ONE
    base = a
    while e:
        if e & 1:
            r = fq2_mul(r, base)
        base = fq2_sqr(base)
        e >>= 1
    return r


# The Frobenius/final-exp constants below are specific to the BLS12-381
# tower (xi = 1 + u, sextic M-twist, 3 | q-1 and 6 | q-1); computing them
# under another active curve would silently export wrong-semantics values
# (ADVICE r2), so they are gated — non-BLS curves route through the
# config-driven engine at the bottom of this module and never touch them.
_IS_BLS381 = getattr(P, "CURVE_NAME", "bls12_381") == "bls12_381"

if _IS_BLS381:
    _XI = (1, 1)
    _FROB_V = fq2_pow(_XI, (Q - 1) // 3)
    _FROB_W = fq2_pow(_XI, (Q - 1) // 6)
    _FROB_GAMMA = [
        [fq2_mul(fq2_pow(_FROB_V, i), fq2_pow(_FROB_W, j)) for i in range(3)]
        for j in range(2)
    ]
else:  # pragma: no cover - trap for accidental BLS-tower use
    _XI = _FROB_V = _FROB_W = _FROB_GAMMA = None


def fq12_frob(a):
    """The q-power Frobenius map (one application; BLS12-381 tower only)."""
    if _FROB_GAMMA is None:
        raise RuntimeError(
            "fq12_frob is specialised to the BLS12-381 tower; use "
            "fields/pairing_generic.py for other curves"
        )
    return tuple(
        tuple(
            fq2_mul(fq2_conj(six[i]), _FROB_GAMMA[j][i]) for i in range(3)
        )
        for j, six in enumerate(a)
    )


# hard-part exponent (q^4 - q^2 + 1)/r decomposed in base q: since
# m^(q^i) = frob^i(m), m^d = prod_i frob^i(m^{d_i}) — 4 exponentiations of
# ~381/381/381/126 bits instead of one ~4317-bit ladder (~3.4x fewer
# squarings), derived numerically so no hand-copied addition chain can rot.
if _IS_BLS381:
    _HARD = (Q**4 - Q**2 + 1) // P.R_MODULUS
    _HARD_DIGITS = [(_HARD // Q**i) % Q for i in range(3)] + [_HARD // Q**3]
else:  # pragma: no cover
    _HARD = _HARD_DIGITS = None


def final_exponentiation(f):
    # easy part: m = f^((q^6-1)(q^2+1)); conjugation IS the q^6-power map
    m = fq12_mul(fq12_conj(f), fq12_inv(f))
    m = fq12_mul(fq12_frob(fq12_frob(m)), m)
    # hard part via the base-q digit decomposition; the four digit
    # exponentiations share one square chain of m (one ~381-step ladder
    # instead of four)
    digits = _HARD_DIGITS
    acc = [FQ12_ONE] * len(digits)
    sq = m
    for b in range(max(d.bit_length() for d in digits)):
        for i, d in enumerate(digits):
            if (d >> b) & 1:
                acc[i] = fq12_mul(acc[i], sq)
        sq = fq12_sqr(sq)
    out = acc[0]
    for i in range(1, len(digits)):
        t = acc[i]
        for _ in range(i):
            t = fq12_frob(t)
        out = fq12_mul(out, t)
    return out


def pairing(p_affine, q_affine):
    return final_exponentiation(miller_loop(p_affine, q_affine))


def multi_pairing(pairs) -> bool:
    """Check prod_i e(P_i, Q_i) == 1 with a single final exponentiation.

    Routes through the native C pairing engine when built (same tower,
    same Miller loop structure, bit-identical Fq12 values — see
    tests/test_native_pairing.py); this pure-Python path is the fallback
    and the parity oracle."""
    from . import native_curve as nc

    if nc.available():
        return nc.multi_pairing(list(pairs))
    f = FQ12_ONE
    for p, q in pairs:
        f = fq12_mul(f, miller_loop(p, q))
    return final_exponentiation(f) == FQ12_ONE
    return final_exponentiation(f) == FQ12_ONE


# --- Non-BLS dispatch --------------------------------------------------------
# Everything above the Fq2 layer in this module is specialised to the
# BLS12-381 tower/ate loop (xi = 1+u, the x-ate structure, the M-twist psi).
# Other active curves route through the config-driven engine
# (fields/pairing_generic.py), which shares none of those assumptions.

if getattr(P, "CURVE_NAME", "bls12_381") != "bls12_381":
    from .pairing_generic import GenericPairing as _GP

    _ENGINE = _GP(P)

    def miller_loop(p_affine, q_affine):  # noqa: F811
        if p_affine is None or q_affine is None:
            return _ENGINE.tw.ONE
        return _ENGINE.miller_loop(q_affine, p_affine)

    def final_exponentiation(f):  # noqa: F811
        return _ENGINE.tw.pow(f, _ENGINE.final_exp)

    def pairing(p_affine, q_affine):  # noqa: F811
        return _ENGINE.pairing(p_affine, q_affine)

    def multi_pairing(pairs) -> bool:  # noqa: F811
        f = _ENGINE.tw.ONE
        for p, q in pairs:
            f = _ENGINE.tw.mul(f, miller_loop(p, q))
        return final_exponentiation(f) == _ENGINE.tw.ONE
