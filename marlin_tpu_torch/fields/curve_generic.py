"""Curve-generic host group arithmetic (G1 over Fq, G2 over Fq2).

Config-driven counterpart of the BLS12-381-specialised
:mod:`marlin_tpu_torch.fields.host_curve`: the group law here takes the short-
Weierstrass ``a`` coefficient from the curve config (the MNT curves the
reference benches have a != 0 — reference benches/bench.rs:5-11), so adding
a curve is a constants file, not new formulas.  Mirrors the `ark-ec`
AffineCurve slice (SURVEY.md §2b row 2).

Points are affine tuples (None = identity): G1 coordinates are ints mod q,
G2 coordinates are Fq2 pairs.
"""

from __future__ import annotations

from .pairing_generic import Tower12


class GenericCurve:
    def __init__(self, cfg):
        self.cfg = cfg
        self.q = cfg.Q_MODULUS
        self.r = cfg.R_MODULUS
        self.tw = Tower12(cfg)
        self.a = getattr(cfg, "CURVE_A", 0) % self.q
        self.b = cfg.CURVE_B % self.q
        # twist coefficients: a' in Fq2 (a times the right xi power is
        # curve-family-specific; configs with a != 0 must supply
        # CURVE_A_TWIST explicitly), b' from config
        self.a_twist = getattr(cfg, "CURVE_A_TWIST", (0, 0))
        self.b_twist = cfg.CURVE_B_TWIST
        self.g1_gen = (cfg.G1_GENERATOR_X % self.q, cfg.G1_GENERATOR_Y % self.q)
        self.g2_gen = (cfg.G2_GENERATOR_X, cfg.G2_GENERATOR_Y)

    # ---------------- G1 (Fq) ----------------
    def g1_is_on_curve(self, p) -> bool:
        if p is None:
            return True
        x, y = p
        q = self.q
        return y * y % q == (x * x % q * x + self.a * x + self.b) % q

    def g1_add(self, p, s):
        q = self.q
        if p is None:
            return s
        if s is None:
            return p
        x1, y1 = p
        x2, y2 = s
        if x1 == x2:
            if (y1 + y2) % q == 0:
                return None
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, q) % q
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, q) % q
        x3 = (lam * lam - x1 - x2) % q
        return (x3, (lam * (x1 - x3) - y1) % q)

    def g1_neg(self, p):
        return None if p is None else (p[0], (-p[1]) % self.q)

    def g1_mul(self, p, k: int):
        k %= self.r
        acc = None
        base = p
        while k:
            if k & 1:
                acc = self.g1_add(acc, base)
            base = self.g1_add(base, base)
            k >>= 1
        return acc

    # ---------------- G2 (Fq2) ----------------
    def g2_is_on_curve(self, p) -> bool:
        if p is None:
            return True
        tw = self.tw
        x, y = p
        rhs = tw.fq2_add(
            tw.fq2_add(tw.fq2_mul(tw.fq2_sqr(x), x), tw.fq2_mul(self.a_twist, x)),
            self.b_twist,
        )
        return tw.fq2_sqr(y) == rhs

    def g2_add(self, p, s):
        tw = self.tw
        if p is None:
            return s
        if s is None:
            return p
        x1, y1 = p
        x2, y2 = s
        if x1 == x2:
            if tw.fq2_add(y1, y2) == (0, 0):
                return None
            num = tw.fq2_add(tw.fq2_mul(tw.fq2_scalar(3), tw.fq2_sqr(x1)), self.a_twist)
            lam = tw.fq2_mul(num, tw.fq2_inv(tw.fq2_mul(tw.fq2_scalar(2), y1)))
        else:
            lam = tw.fq2_mul(tw.fq2_sub(y2, y1), tw.fq2_inv(tw.fq2_sub(x2, x1)))
        x3 = tw.fq2_sub(tw.fq2_sub(tw.fq2_sqr(lam), x1), x2)
        return (x3, tw.fq2_sub(tw.fq2_mul(lam, tw.fq2_sub(x1, x3)), y1))

    def g2_neg(self, p):
        return None if p is None else (p[0], self.tw.fq2_neg(p[1]))

    def g2_mul(self, p, k: int):
        k %= self.r
        acc = None
        base = p
        while k:
            if k & 1:
                acc = self.g2_add(acc, base)
            base = self.g2_add(base, base)
            k >>= 1
        return acc
