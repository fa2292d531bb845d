"""Deterministic randomness sources.

`ZkRng` supplies the prover's blinding values (the reference threads a
user-supplied `zk_rng` — src/lib.rs:151; tests pin `ark_std::test_rng()`
for reproducibility, SURVEY.md §4 row 6).  Bulk sampling is vectorized via
numpy so mask-polynomial generation stays off the Python hot path.
"""

from __future__ import annotations

import numpy as np

from ..fields import active as P

R = P.R_MODULUS


class ZkRng:
    """Seedable Fr sampler (PCG64-backed; not a transcript object)."""

    def __init__(self, seed: int | None = 0):
        self._gen = np.random.Generator(np.random.PCG64(seed))

    def rand_fr(self) -> int:
        while True:
            b = self._gen.bytes(P.FR_BYTES)
            v = int.from_bytes(b, "little") & ((1 << P.FR_BITS) - 1)
            if v < R:
                return v

    def rand_fr_list(self, n: int) -> list[int]:
        nb = P.FR_BYTES
        out: list[int] = []
        while len(out) < n:
            chunk = self._gen.bytes(nb * (n - len(out)))
            for i in range(0, len(chunk), nb):
                v = int.from_bytes(chunk[i : i + nb], "little") & ((1 << P.FR_BITS) - 1)
                if v < R:
                    out.append(v)
        return out

    def rand_fr_limbs(self, n: int) -> np.ndarray:
        """[n, FR_BYTES/2] uint32 canonical 16-bit limbs — the SAME value
        stream as rand_fr_list (byte-identical consumption and rejection),
        but fully vectorized: the Python int loop cost ~125 ms per mask
        polynomial at 2^14 on the prove hot path."""
        nb = P.FR_BYTES
        # per-byte mask of (1 << FR_BITS) - 1, little-endian
        mask = np.full(nb, 0xFF, np.uint8)
        top_bits = P.FR_BITS - 8 * (P.FR_BITS // 8)
        for b in range(P.FR_BITS // 8, nb):
            mask[b] = (1 << top_bits) - 1 if b == P.FR_BITS // 8 else 0
        r_be = np.frombuffer(
            R.to_bytes(nb, "little"), dtype=np.uint8
        )[::-1].copy()
        rows = []
        have = 0
        while have < n:
            m = n - have
            arr = np.frombuffer(self._gen.bytes(nb * m), dtype=np.uint8).reshape(m, nb)
            arr = arr & mask[None, :]
            be = arr[:, ::-1]
            less = np.zeros(m, bool)
            greater = np.zeros(m, bool)
            for j in range(nb):  # lexicographic be < r_be
                undecided = ~(less | greater)
                less |= undecided & (be[:, j] < r_be[j])
                greater |= undecided & (be[:, j] > r_be[j])
            acc = arr[less]
            rows.append(acc)
            have += acc.shape[0]
        allb = np.concatenate(rows, axis=0)
        return (
            np.ascontiguousarray(allb).view("<u2").reshape(n, nb // 2).astype(np.uint32)
        )


def test_rng() -> ZkRng:
    """Fixed-seed rng for reproducible proofs (ark_std::test_rng analog)."""
    return ZkRng(0)
