"""Curve-generic host pairing: tower construction + ate Miller loop.

The reference is generic over `PairingEngine` and instantiates five curves
(reference benches/bench.rs:5-11); this module is the framework's analog of
that genericity for the host crypto layer.  Where
:mod:`marlin_tpu_torch.fields.host_pairing` is the hand-specialised BLS12-381
implementation (kept — it is the tuned path for the flagship curve), this
module builds the same machinery *from a curve-config module*:

* ``Tower12(cfg)`` — Fq2/Fq6/Fq12 in the standard 2-3-2 tower
  (Fq2 = Fq[u]/(u^2 - nr2), Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v))
  with the non-residues taken from the config, covering both BLS12-381
  (nr2 = -1, xi = 1+u) and BN254 (nr2 = -1, xi = 9+u).
* ``GenericPairing(cfg)`` — ate pairing ``e(P, Q) = f_{T,Q}(P)^((q^k-1)/r)``
  with ``T = trace - 1``: an affine Miller loop with explicit Fq12 line
  slopes (no sparse-multiplication index conventions to get wrong) and a
  plain square-and-multiply final exponentiation by the integer
  ``(q^k - 1) // r``.  Slow by pairing-implementation standards and
  entirely off the device hot path: the verifier runs a handful of pairings
  (reference src/lib.rs:413-423), and correctness-over-cleverness is the
  right trade for a host-side generic engine.  M- and D-type twists are
  both supported (config ``TWIST_TYPE``).

Group law helpers here accept a general short-Weierstrass ``a`` coefficient
(the MNT curves have a != 0) so future curve configs only supply constants.
"""

from __future__ import annotations

import functools


class Tower12:
    """Fq2/Fq6/Fq12 arithmetic from a curve config (2-3-2 tower)."""

    def __init__(self, cfg):
        self.q = cfg.Q_MODULUS
        self.nr2 = getattr(cfg, "FQ2_NONRESIDUE", -1) % self.q
        self.xi = tuple(c % self.q for c in cfg.FQ6_NONRESIDUE)

    # --- Fq2: (c0, c1) = c0 + c1*u, u^2 = nr2 ---
    def fq2_add(self, a, b):
        q = self.q
        return ((a[0] + b[0]) % q, (a[1] + b[1]) % q)

    def fq2_sub(self, a, b):
        q = self.q
        return ((a[0] - b[0]) % q, (a[1] - b[1]) % q)

    def fq2_neg(self, a):
        q = self.q
        return ((-a[0]) % q, (-a[1]) % q)

    def fq2_mul(self, a, b):
        q = self.q
        t0 = a[0] * b[0] % q
        t1 = a[1] * b[1] % q
        return ((t0 + self.nr2 * t1) % q, (a[0] * b[1] + a[1] * b[0]) % q)

    def fq2_sqr(self, a):
        return self.fq2_mul(a, a)

    def fq2_inv(self, a):
        q = self.q
        # norm = a0^2 - nr2 * a1^2
        d = pow((a[0] * a[0] - self.nr2 * a[1] * a[1]) % q, -1, q)
        return (a[0] * d % q, (-a[1]) * d % q)

    def fq2_scalar(self, s):
        return (s % self.q, 0)

    FQ2_ZERO = property(lambda self: (0, 0))
    FQ2_ONE = property(lambda self: (1, 0))

    # --- Fq6: 3-tuple of Fq2, v^3 = xi ---
    def _mul_by_xi(self, a):
        return self.fq2_mul(a, self.xi)

    def fq6_add(self, a, b):
        return tuple(self.fq2_add(x, y) for x, y in zip(a, b))

    def fq6_sub(self, a, b):
        return tuple(self.fq2_sub(x, y) for x, y in zip(a, b))

    def fq6_neg(self, a):
        return tuple(self.fq2_neg(x) for x in a)

    def fq6_mul(self, a, b):
        m = self.fq2_mul
        add = self.fq2_add
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0, t1, t2 = m(a0, b0), m(a1, b1), m(a2, b2)
        c0 = add(t0, self._mul_by_xi(add(m(a1, b2), m(a2, b1))))
        c1 = add(add(m(a0, b1), m(a1, b0)), self._mul_by_xi(t2))
        c2 = add(add(m(a0, b2), m(a2, b0)), t1)
        return (c0, c1, c2)

    def fq6_sqr(self, a):
        return self.fq6_mul(a, a)

    def fq6_inv(self, a):
        # standard 3-term inverse via the adjugate
        m = self.fq2_mul
        sub = self.fq2_sub
        a0, a1, a2 = a
        c0 = sub(m(a0, a0), self._mul_by_xi(m(a1, a2)))
        c1 = sub(self._mul_by_xi(m(a2, a2)), m(a0, a1))
        c2 = sub(m(a1, a1), m(a0, a2))
        t = self.fq2_add(
            self.fq2_add(self._mul_by_xi(m(a2, c1)), self._mul_by_xi(m(a1, c2))),
            m(a0, c0),
        )
        ti = self.fq2_inv(t)
        return (m(c0, ti), m(c1, ti), m(c2, ti))

    FQ6_ZERO = property(lambda self: ((0, 0),) * 3)
    FQ6_ONE = property(lambda self: ((1, 0), (0, 0), (0, 0)))

    # --- Fq12: 2-tuple of Fq6, w^2 = v ---
    def _mul_by_v(self, a):
        # (a0, a1, a2) * v = (xi*a2, a0, a1)
        return (self._mul_by_xi(a[2]), a[0], a[1])

    def add(self, a, b):
        return (self.fq6_add(a[0], b[0]), self.fq6_add(a[1], b[1]))

    def sub(self, a, b):
        return (self.fq6_sub(a[0], b[0]), self.fq6_sub(a[1], b[1]))

    def neg(self, a):
        return (self.fq6_neg(a[0]), self.fq6_neg(a[1]))

    def mul(self, a, b):
        t0 = self.fq6_mul(a[0], b[0])
        t1 = self.fq6_mul(a[1], b[1])
        c0 = self.fq6_add(t0, self._mul_by_v(t1))
        c1 = self.fq6_add(self.fq6_mul(a[0], b[1]), self.fq6_mul(a[1], b[0]))
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        t = self.fq6_sub(self.fq6_mul(a[0], a[0]), self._mul_by_v(self.fq6_mul(a[1], a[1])))
        ti = self.fq6_inv(t)
        return (self.fq6_mul(a[0], ti), self.fq6_neg(self.fq6_mul(a[1], ti)))

    ZERO = property(lambda self: (((0, 0),) * 3,) * 2)
    ONE = property(lambda self: (((1, 0), (0, 0), (0, 0)), ((0, 0),) * 3))

    def pow(self, a, e):
        r = self.ONE
        base = a
        while e:
            if e & 1:
                r = self.mul(r, base)
            base = self.sqr(base)
            e >>= 1
        return r

    def scalar(self, s):
        return ((self.fq2_scalar(s), (0, 0), (0, 0)), ((0, 0),) * 3)

    def from_fq2(self, a):
        return ((a, (0, 0), (0, 0)), ((0, 0),) * 3)

    # w^n as an Fq12 element (w = (0, 1) in the Fq6 pair basis)
    @functools.lru_cache(maxsize=None)
    def w_pow(self, n):
        w = (self.FQ6_ZERO, self.FQ6_ONE)
        return self.pow(w, n)


class GenericPairing:
    """Ate pairing from a curve config; see module docstring."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.tw = Tower12(cfg)
        self.q = cfg.Q_MODULUS
        self.r = cfg.R_MODULUS
        self.k = cfg.EMBEDDING_DEGREE
        assert self.k == 12, "Tower12 engine covers embedding degree 12"
        self.T = cfg.TRACE - 1  # ate loop count
        self.final_exp = (self.q**self.k - 1) // self.r
        # Frobenius data: v^q = v * xi^((q-1)/3), w^q = w * xi^((q-1)/6),
        # q-power conjugates Fq2 coefficients (3, 6 | q-1 for any curve
        # this tower shape fits).  gamma[j][i] scales coefficient c_{ji}.
        q = self.q
        tw = self.tw
        fv = self._fq2_pow(tw.xi, (q - 1) // 3)
        fw = self._fq2_pow(tw.xi, (q - 1) // 6)
        self._gamma = [
            [tw.fq2_mul(self._fq2_pow(fv, i), self._fq2_pow(fw, j)) for i in range(3)]
            for j in range(2)
        ]
        # hard part (q^4 - q^2 + 1)/r in base-q digits: m^d = prod frob^i(m^{d_i})
        hard = (q**4 - q**2 + 1) // self.r
        self._hard_digits = [(hard // q**i) % q for i in range(3)] + [hard // q**3]

    def _fq2_pow(self, a, e: int):
        tw = self.tw
        r = (1, 0)
        base = a
        while e:
            if e & 1:
                r = tw.fq2_mul(r, base)
            base = tw.fq2_sqr(base)
            e >>= 1
        return r

    def _fq2_conj(self, a):
        return (a[0], (-a[1]) % self.q)

    def frobenius(self, x):
        """The q-power map on Fq12."""
        tw = self.tw
        return tuple(
            tuple(
                tw.fq2_mul(self._fq2_conj(six[i]), self._gamma[j][i])
                for i in range(3)
            )
            for j, six in enumerate(x)
        )

    def _conj12(self, x):
        """Conjugation (the q^6-power map): negate the w-part."""
        return (x[0], self.tw.fq6_neg(x[1]))

    def final_exponentiation(self, f):
        tw = self.tw
        # easy: m = f^((q^6-1)(q^2+1))
        m = tw.mul(self._conj12(f), tw.inv(f))
        m = tw.mul(self.frobenius(self.frobenius(m)), m)
        # hard via base-q digits with a shared square chain
        digits = self._hard_digits
        acc = [tw.ONE] * len(digits)
        sq = m
        for b in range(max(d.bit_length() for d in digits)):
            for i, d in enumerate(digits):
                if (d >> b) & 1:
                    acc[i] = tw.mul(acc[i], sq)
            sq = tw.sqr(sq)
        out = acc[0]
        for i in range(1, len(digits)):
            t = acc[i]
            for _ in range(i):
                t = self.frobenius(t)
            out = tw.mul(out, t)
        return out

    # --- untwist: E'(Fq2) -> E(Fq12) ---
    def _untwist(self, pt):
        if pt is None:
            return None
        tw = self.tw
        x, y = pt
        if self.cfg.TWIST_TYPE == "D":
            # E': y^2 = x^3 + b/xi; psi(x, y) = (x w^2, y w^3)
            xf = tw.mul(tw.from_fq2(x), tw.w_pow(2))
            yf = tw.mul(tw.from_fq2(y), tw.w_pow(3))
        else:
            # M-twist E': y^2 = x^3 + b*xi; psi(x, y) = (x / w^2, y / w^3)
            xf = tw.mul(tw.from_fq2(x), tw.inv(tw.w_pow(2)))
            yf = tw.mul(tw.from_fq2(y), tw.inv(tw.w_pow(3)))
        return (xf, yf)

    # --- E(Fq12) affine group law (general a; MNT-ready) ---
    def _ec_add(self, p, qpt):
        tw = self.tw
        if p is None:
            return qpt
        if qpt is None:
            return p
        x1, y1 = p
        x2, y2 = qpt
        if x1 == x2:
            if y1 != y2 or y1 == tw.ZERO:
                return None
            a12 = tw.scalar(self.cfg.CURVE_A)
            num = tw.add(tw.mul(tw.scalar(3), tw.sqr(x1)), a12)
            lam = tw.mul(num, tw.inv(tw.mul(tw.scalar(2), y1)))
        else:
            lam = tw.mul(tw.sub(y2, y1), tw.inv(tw.sub(x2, x1)))
        x3 = tw.sub(tw.sub(tw.sqr(lam), x1), x2)
        y3 = tw.sub(tw.mul(lam, tw.sub(x1, x3)), y1)
        return (x3, y3)

    # --- Miller loop with explicit line evaluations ---
    def _line(self, a, b, p):
        """l_{a,b}(p) for points a, b on E(Fq12), p = (xp, yp) in Fq12."""
        tw = self.tw
        xp, yp = p
        if a is None or b is None:
            # vertical through the non-infinite one (or constant 1)
            fin = a if a is not None else b
            if fin is None:
                return tw.ONE
            return tw.sub(xp, fin[0])
        x1, y1 = a
        x2, y2 = b
        if x1 == x2 and y1 != y2:
            return tw.sub(xp, x1)  # vertical line
        if x1 == x2:
            a12 = tw.scalar(self.cfg.CURVE_A)
            num = tw.add(tw.mul(tw.scalar(3), tw.sqr(x1)), a12)
            lam = tw.mul(num, tw.inv(tw.mul(tw.scalar(2), y1)))
        else:
            lam = tw.mul(tw.sub(y2, y1), tw.inv(tw.sub(x2, x1)))
        return tw.sub(tw.sub(yp, y1), tw.mul(lam, tw.sub(xp, x1)))

    def miller_loop(self, qpt, ppt):
        """f_{T, Q}(P): Q in E'(Fq2) (untwisted internally), P in E(Fq)."""
        tw = self.tw
        Q = self._untwist(qpt)
        P = (tw.scalar(ppt[0]), tw.scalar(ppt[1]))
        T = self.T
        neg = T < 0
        n = abs(T)
        f = tw.ONE
        R = Q
        for bit in bin(n)[3:]:
            f = tw.mul(tw.sqr(f), self._line(R, R, P))
            R = self._ec_add(R, R)
            if bit == "1":
                f = tw.mul(f, self._line(R, Q, P))
                R = self._ec_add(R, Q)
        if neg:
            f = tw.inv(f)
        return f

    def pairing(self, ppt, qpt):
        """e(P, Q) for P in G1 (affine ints), Q in G2 (affine Fq2 pairs).

        Returns an Fq12 element of order dividing r; identity inputs map to
        the unit.  Non-degenerate and bilinear (tests/test_bn254.py).
        """
        if ppt is None or qpt is None:
            return self.tw.ONE
        f = self.miller_loop(qpt, ppt)
        return self.final_exponentiation(f)
