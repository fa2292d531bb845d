"""Marlin's Fiat-Shamir transcript and the setup's sampler, in plain Python.

The transcript is arkworks marlin's `SimpleHashFiatShamirRng<Blake2s,
ChaChaRng>` (src/rng.rs): the seed is Blake2s-256 of the initial bytes,
each absorb hashes the new bytes followed by the old seed, and the stream
is ChaCha20 keyed by the seed (djb layout, 64-bit block counter from 0,
zero nonce), consumed one 32-bit word at a time.  A field element is
ark-ff's `UniformRand`: four u64 draws, the top bits above the field's
size cleared, rejection at or above r, and the accepted integer read as a
Montgomery representation (multiplied by 2^-256 mod r).

`setup_trapdoor` reproduces the two draws the setup makes from its seed:
numpy's PCG64 stream, 32 little-endian bytes an element, the bits above
the field's size cleared, rejection at or above r.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from .curves import Curve

_MASK32 = 0xFFFFFFFF


def _rotl(v: int, c: int) -> int:
    return ((v << c) | (v >> (32 - c))) & _MASK32


def chacha20_block(key: bytes, counter: int) -> list:
    """The 16 output words of one ChaCha20 block (20 rounds)."""
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574, *struct.unpack("<8I", key),
             counter & _MASK32, counter >> 32, 0, 0]
    x = list(state)
    for _ in range(10):
        for a, b, c, d in ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
                           (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14)):
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl(x[d] ^ x[a], 16)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl(x[b] ^ x[c], 12)
            x[a] = (x[a] + x[b]) & _MASK32
            x[d] = _rotl(x[d] ^ x[a], 8)
            x[c] = (x[c] + x[d]) & _MASK32
            x[b] = _rotl(x[b] ^ x[c], 7)
    return [(x[i] + state[i]) & _MASK32 for i in range(16)]


class Transcript:
    def __init__(self, curve: Curve, initial: bytes):
        self.curve = curve
        self._reseed(hashlib.blake2s(initial).digest())

    def _reseed(self, seed: bytes) -> None:
        self.seed = seed
        self._counter = 0
        self._words: list = []

    def absorb(self, data: bytes) -> None:
        self._reseed(hashlib.blake2s(data + self.seed).digest())

    def _u32(self) -> int:
        if not self._words:
            self._words = chacha20_block(self.seed, self._counter)
            self._counter += 1
        return self._words.pop(0)

    def _u64(self) -> int:
        lo = self._u32()
        return (self._u32() << 32) | lo

    def rand_fr(self) -> int:
        c = self.curve
        while True:
            limbs = [self._u64() for _ in range(4)]
            limbs[3] &= (1 << (c.fr_bits - 192)) - 1
            v = sum(l << (64 * i) for i, l in enumerate(limbs))
            if v < c.r:
                return v * c.mont_r_inv % c.r

    def rand_u128(self) -> int:
        lo = self._u64()
        return (self._u64() << 64) | lo


def sample_fr(gen: np.random.Generator, curve: Curve) -> int:
    """One element from 32 bytes of a numpy generator, by rejection."""
    while True:
        v = int.from_bytes(gen.bytes(32), "little") & ((1 << curve.fr_bits) - 1)
        if v < curve.r:
            return v


def setup_trapdoor(curve: Curve, setup_seed: int) -> tuple:
    """(tau, gamma) that a setup drawing from PCG64(setup_seed) makes."""
    gen = np.random.Generator(np.random.PCG64(setup_seed))
    tau = sample_fr(gen, curve)
    return tau, sample_fr(gen, curve)


def fr_bytes(v: int) -> bytes:
    return v.to_bytes(32, "little")


def u64_bytes(v: int) -> bytes:
    return v.to_bytes(8, "little")
