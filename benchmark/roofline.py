"""The yardstick of the kernel rooflines: the card's peaks and the work of
each measured kernel, counted from the algorithm and its inputs' shapes, so
that any implementation of a kernel reads against the same work.

Peaks of one NVIDIA H100 SXM (80 GB HBM3): 3.35 TB/s of HBM bandwidth
(NVIDIA's data sheet), and 8.36e12 32-bit integer multiplies a second: 32
IMAD.WIDE (one 32 x 32 -> 64-bit product each) a clock on each of 132 SMs
at the 1,980 MHz maximum SM clock.  The port's field arithmetic is such
products; the card sustains 93-94% of this rate in a loop of nothing else.
Both assume the full 700 W; the result line records the card's power limit.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_MULS_PER_S = 32 * 132 * 1.98e9

# madd-2007-bl (Jacobian + affine, the fold's addition): 7 products and 4 squares
MIXED_ADD_PRODUCTS = 11


def montgomery_muls(words: int) -> int:
    """32-bit limb products of one Montgomery product over `words` words:
    the schoolbook product and the reduction, words^2 each."""
    return 2 * words * words


def fold_work(filled_per_lane, distinct_rows: int, lanes: int, cap: int, fq_words: int) -> tuple:
    """(integer multiplies, bytes) that one bucket fold needs at least.

    A lane of f filled slots sums f affine points: f - 1 mixed additions.
    Bytes: each distinct table row read once (x and y, 8 bytes a word), the
    [lanes, cap] int32 layout, and the lanes' Jacobian sums (three [lanes,
    2 words] int32 coordinates of 16-bit limbs) and int32 flags written."""
    adds = sum(max(int(f) - 1, 0) for f in filled_per_lane)
    ops = adds * MIXED_ADD_PRODUCTS * montgomery_muls(fq_words)
    nbytes = distinct_rows * 8 * fq_words + lanes * cap * 4 + lanes * (3 * 2 * fq_words * 4 + 4)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_INT_MULS_PER_S, nbytes / PEAK_BYTES_PER_S)
