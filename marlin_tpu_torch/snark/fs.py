"""Fiat-Shamir transcript RNG (reference src/rng.rs).

`SimpleHashFiatShamirRng<Blake2s, ChaChaRng>` semantics:
  * initialize: seed = Blake2s-256(initial_bytes); rng = ChaCha20(seed)
  * absorb:     seed = Blake2s-256(new_bytes || seed); rng reseeded
    (reference src/rng.rs:54-79)

The ChaCha20 stream follows rand_chacha's `ChaChaRng` (djb variant, 64-bit
block counter starting at 0, zero nonce, words consumed sequentially), and
field sampling follows ark-ff's `UniformRand`: four u64 draws, top bit
masked (REPR_SHAVE_BITS=1 for the 255-bit Fr), rejection if >= r, and the
accepted bigint is interpreted as the Montgomery representation.  Transcript
work is tiny (a few hundred bytes per proof), so this runs on the host.
"""

from __future__ import annotations

import hashlib
import struct

from ..fields import active as P
from . import native

R = P.R_MODULUS
_FR_MONT_R_INV = pow(P.FR_MONT_R, -1, R)
_NATIVE = native.available()


def _rotl32(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & 0xFFFFFFFF


def _chacha_block(key_words, counter: int) -> list[int]:
    consts = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
    state = list(consts) + list(key_words) + [
        counter & 0xFFFFFFFF,
        (counter >> 32) & 0xFFFFFFFF,
        0,
        0,
    ]
    x = state[:]

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & 0xFFFFFFFF
        x[d] = _rotl32(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & 0xFFFFFFFF
        x[b] = _rotl32(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & 0xFFFFFFFF
        x[d] = _rotl32(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & 0xFFFFFFFF
        x[b] = _rotl32(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(x[i] + state[i]) & 0xFFFFFFFF for i in range(16)]


class ChaCha20Rng:
    """Word-stream RNG matching rand_chacha::ChaChaRng(seed, nonce=0)."""

    def __init__(self, seed: bytes):
        assert len(seed) == 32
        self._seed_bytes = seed
        self.key = struct.unpack("<8I", seed)
        self.counter = 0
        self.buf: list[int] = []

    def next_u32(self) -> int:
        if not self.buf:
            if _NATIVE:
                raw = native.chacha20_block(self._seed_bytes, self.counter)
                self.buf = list(struct.unpack("<16I", raw))
            else:
                self.buf = _chacha_block(self.key, self.counter)
            self.counter += 1
        return self.buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return (hi << 32) | lo


class FiatShamirRng:
    """SimpleHashFiatShamirRng<Blake2s, ChaChaRng> (reference src/rng.rs:18-80)."""

    def __init__(self, initial_input: bytes):
        if _NATIVE:
            self.seed = native.blake2s256(initial_input)
        else:
            self.seed = hashlib.blake2s(initial_input).digest()
        self.rng = ChaCha20Rng(self.seed)

    def absorb(self, new_input: bytes) -> None:
        if _NATIVE:
            self.seed = native.fs_absorb(new_input, self.seed)
        else:
            self.seed = hashlib.blake2s(new_input + self.seed).digest()
        self.rng = ChaCha20Rng(self.seed)

    # --- sampling -----------------------------------------------------------

    def rand_fr(self) -> int:
        """ark-ff UniformRand for Fr: rejection-sample a 255-bit Montgomery
        repr, return the canonical value it represents."""
        shave = 64 * ((P.FR_BITS + 63) // 64) - P.FR_BITS  # REPR_SHAVE_BITS
        n_limbs = (P.FR_BITS + 63) // 64
        while True:
            limbs = [self.rng.next_u64() for _ in range(n_limbs)]
            limbs[-1] &= (1 << (64 - shave)) - 1  # u64::MAX >> shave
            repr_ = sum(l << (64 * i) for i, l in enumerate(limbs))
            if repr_ < R:
                return repr_ * _FR_MONT_R_INV % R

    def rand_u128(self) -> int:
        """rand's Standard u128: low u64 then high u64 (reference src/lib.rs:290)."""
        x = self.rng.next_u64()
        y = self.rng.next_u64()
        return (y << 64) | x
