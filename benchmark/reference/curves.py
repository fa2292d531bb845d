"""The two curves' public parameters and plain G1 arithmetic in Python ints.

Constants are the published ones of BLS12-381 (IETF draft-irtf-cfrg-
pairing-friendly-curves, section 4.2.1) and of BN254 (alt_bn128, EIP-196).
Points are affine (x, y) tuples, None the identity; the arithmetic runs in
Jacobian coordinates for y^2 = x^3 + b.  Nothing here imports the port.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Curve:
    name: str
    r: int  # scalar field Fr
    q: int  # base field Fq
    b: int
    gen: tuple
    fr_bits: int
    fr_generator: int  # multiplicative generator of Fr
    two_adicity: int
    fq_bytes: int

    @property
    def two_adic_root(self) -> int:
        return pow(self.fr_generator, (self.r - 1) >> self.two_adicity, self.r)

    @property
    def mont_r_inv(self) -> int:
        """Inverse of 2^256 mod r: ark-ff reads a sampled 4-limb integer as a
        Montgomery representation."""
        return pow(1 << 256, -1, self.r)


CURVES = {
    "bls12_381": Curve(
        name="bls12_381",
        r=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
        q=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
        b=4,
        gen=(
            0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
            0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
        ),
        fr_bits=255,
        fr_generator=7,
        two_adicity=32,
        fq_bytes=48,
    ),
    "bn254": Curve(
        name="bn254",
        r=21888242871839275222246405745257275088548364400416034343698204186575808495617,
        q=21888242871839275222246405745257275088696311157297823662689037894645226208583,
        b=3,
        gen=(1, 2),
        fr_bits=254,
        fr_generator=5,
        two_adicity=28,
        fq_bytes=32,
    ),
}


class G1:
    """Plain G1 group law over one curve."""

    def __init__(self, curve: Curve):
        self.c = curve
        self.q = curve.q

    # Jacobian (X, Y, Z); Z == 0 is the identity
    def _jac(self, p):
        return (1, 1, 0) if p is None else (p[0], p[1], 1)

    def _double(self, P):
        X, Y, Z = P
        q = self.q
        if Z == 0 or Y == 0:
            return (1, 1, 0)
        A = X * X % q
        B = Y * Y % q
        C = B * B % q
        D = 2 * ((X + B) * (X + B) - A - C) % q
        E = 3 * A % q
        X3 = (E * E - 2 * D) % q
        Y3 = (E * (D - X3) - 8 * C) % q
        Z3 = 2 * Y * Z % q
        return (X3, Y3, Z3)

    def _add(self, P, Q):
        if P[2] == 0:
            return Q
        if Q[2] == 0:
            return P
        q = self.q
        X1, Y1, Z1 = P
        X2, Y2, Z2 = Q
        Z1Z1 = Z1 * Z1 % q
        Z2Z2 = Z2 * Z2 % q
        U1 = X1 * Z2Z2 % q
        U2 = X2 * Z1Z1 % q
        S1 = Y1 * Z2 * Z2Z2 % q
        S2 = Y2 * Z1 * Z1Z1 % q
        if U1 == U2:
            return self._double(P) if S1 == S2 else (1, 1, 0)
        H = (U2 - U1) % q
        I = 4 * H * H % q
        J = H * I % q
        rr = 2 * (S2 - S1) % q
        V = U1 * I % q
        X3 = (rr * rr - J - 2 * V) % q
        Y3 = (rr * (V - X3) - 2 * S1 * J) % q
        Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % q
        return (X3, Y3, Z3)

    def _mul(self, P, k: int):
        k %= self.c.r
        acc = (1, 1, 0)
        for bit in bin(k)[2:] if k else "":
            acc = self._double(acc)
            if bit == "1":
                acc = self._add(acc, P)
        return acc

    def _affine(self, P):
        if P[2] == 0:
            return None
        q = self.q
        zi = pow(P[2], -1, q)
        zi2 = zi * zi % q
        return (P[0] * zi2 % q, P[1] * zi2 * zi % q)

    def mul(self, p, k: int):
        return self._affine(self._mul(self._jac(p), k))

    def msm(self, pairs) -> tuple | None:
        """Σ k·p over (k, p) pairs, one scalar multiplication each."""
        acc = (1, 1, 0)
        for k, p in pairs:
            if p is not None and k % self.c.r:
                acc = self._add(acc, self._mul(self._jac(p), k))
        return self._affine(acc)

    def on_curve(self, p) -> bool:
        if p is None:
            return True
        x, y = p
        return 0 <= x < self.q and 0 <= y < self.q and (y * y - x * x * x - self.c.b) % self.q == 0

    def in_subgroup(self, p) -> bool:
        return self.on_curve(p) and self._mul_raw(self._jac(p), self.c.r)[2] == 0

    def _mul_raw(self, P, k: int):
        acc = (1, 1, 0)
        for bit in bin(k)[2:]:
            acc = self._double(acc)
            if bit == "1":
                acc = self._add(acc, P)
        return acc

    # arkworks byte layouts
    def to_bytes(self, p) -> bytes:
        """ToBytes of an affine point: x || y || infinity byte, little-endian."""
        n = self.c.fq_bytes
        if p is None:
            return bytes(2 * n) + b"\x01"
        return p[0].to_bytes(n, "little") + p[1].to_bytes(n, "little") + b"\x00"

    def decompress(self, data: bytes):
        """CanonicalDeserialize of a compressed point: x with the flags in the
        top two bits of its last byte (bit 7: y is the larger root, bit 6:
        infinity); checks the range, the curve and the subgroup."""
        b = bytearray(data)
        flags = b[-1] & 0xC0
        b[-1] &= 0x3F
        if flags & 0x40:
            return None
        x = int.from_bytes(bytes(b), "little")
        q = self.q
        if x >= q:
            raise ValueError("x out of range")
        y2 = (x * x * x + self.c.b) % q
        y = pow(y2, (q + 1) // 4, q)  # both fields have q = 3 mod 4
        if y * y % q != y2:
            raise ValueError("not on the curve")
        if (y > q - y) != bool(flags & 0x80):
            y = q - y
        p = (x, y)
        if not self.in_subgroup(p):
            raise ValueError("not in the prime-order subgroup")
        return p
