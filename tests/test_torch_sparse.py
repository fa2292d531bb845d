"""The port's sparse ops (marlin_tpu_torch.ops.sparse) against host ints.

The segment sums must stay exact past 2^16 contributions per segment: the
JAX package's uint32 limb sums silently wrapped there once (its round-2
soundness bug), and the port's int64 `index_add_` is exact to ~2^47.
Exact equality: field arithmetic is exact.
"""

import numpy as np
import torch

from marlin_tpu_torch.ops import fr, sparse
from marlin_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

R = fr.CTX.modulus


def _ints(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]


def test_spmv_matches_host():
    rng = np.random.default_rng(1)
    num_rows, num_cols = 40, 30
    rows = []
    for r in range(num_rows):
        cols = rng.choice(num_cols, size=int(rng.integers(0, 6)), replace=False)
        rows.append([(int(c) * 7919 % R if c else R - 1, int(c)) for c in cols])
    m = sparse.CooMatrix.from_rows(rows, num_rows, num_cols, "cpu")
    z = _ints(num_cols, 2)
    got = fr.to_ints(sparse.spmv(m, fr.from_ints(z, "cpu"), 64))
    want = [sum(c * z[j] for c, j in row) % R for row in rows] + [0] * (64 - num_rows)
    assert got == want


def test_scatter_add_exact_past_2_16_contributions_per_segment():
    n = (1 << 16) + 4464  # one segment receives more than 2^16 values
    vals = [R - 1] * 1000 + _ints(n - 1000, 3)  # include the largest residue
    limbs = torch.as_tensor(ints_to_limbs(vals, fr.L).reshape(n, fr.L).astype(np.int32))
    idx = np.zeros(n, dtype=np.int64)
    idx[-7:] = [1, 2, 2, 5, 5, 5, 3]
    got = sparse.scatter_add_mod(limbs, torch.as_tensor(idx), 6)
    want = [0] * 6
    for v, i in zip(vals, idx.tolist()):
        want[i] += v
    # the values are canonical ints here (no Montgomery factor): compare raw limbs
    assert limbs_to_ints(got.numpy()) == [w % R for w in want]


def test_scatter_add_matches_dense_sum_on_random_segments():
    rng = np.random.default_rng(4)
    n, segs = 5000, 37
    vals = _ints(n, 5)
    idx = rng.integers(0, segs, size=n)
    got = sparse.scatter_add_mod(fr.from_ints(vals, "cpu"), torch.as_tensor(idx), segs)
    want = [0] * segs
    for v, i in zip(vals, idx.tolist()):
        want[i] = (want[i] + v) % R
    assert fr.to_ints(got) == want
