"""The port's group law (ops/curve.py, ops/curve_device.py) on the CPU.

The plain versions of kernels 4 and 5 against the JAX package's XLA group
law (limb for limb) and against the host curve arithmetic (affine points).
Inputs come from a seeded numpy generator; points are multiples of the
generator computed on the host.  All comparisons are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlin_tpu.ops import curve_device as jcd
from marlin_tpu.ops.pallas import curve as jcurve
from marlin_tpu_torch.fields import bls12_381 as P
from marlin_tpu_torch.fields import host_curve as hc
from marlin_tpu_torch.ops import curve, fq
from marlin_tpu_torch.ops import curve_device as cd

RNG = np.random.default_rng(20)


def _scalars(n):
    return [int.from_bytes(RNG.bytes(40), "little") % (P.R_MODULUS - 1) + 1 for _ in range(n)]


def _points(n):
    return hc.g1_fixed_base_powers(hc.G1_GEN, _scalars(n))


def _jax(pt):
    return tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in pt)


def _same_limbs(port, ref):
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r).astype(np.int32))


@pytest.fixture(scope="module")
def edge_pairs():
    """12 (p, q) pairs: generic, P + P, P + (-P), identity on either side."""
    p = _points(8)
    a = p[:6] + [p[0], p[1], p[2], None, p[3], None]
    b = p[6:8] + p[2:6] + [p[0], hc.g1_neg(p[1]), None, p[4], hc.g1_neg(p[3]), None]
    return a, b


def test_add_and_double_equal_the_jax_xla_twins(edge_pairs):
    a, b = edge_pairs
    A, B = cd.from_affine_ints(a, "cpu"), cd.from_affine_ints(b, "cpu")
    got = curve.add_plain(A, B)
    _same_limbs(got, jcd._add_xla(_jax(A), _jax(B)))
    _same_limbs(curve.double_plain(A), jcd._double_xla(_jax(A)))
    assert cd.to_affine_ints(got) == [hc.g1_add(x, y) for x, y in zip(a, b)]
    # a Jacobian operand with Z != 1 (the sums above) takes the general formulas
    twice = curve.add_plain(got, got)
    _same_limbs(twice, jcd._add_xla(_jax(got), _jax(got)))
    assert cd.to_affine_ints(twice) == [hc.g1_add(s, s) for s in cd.to_affine_ints(got)]


def test_routed_ops_take_the_plain_versions_on_cpu(edge_pairs):
    a, b = edge_pairs
    A, B = cd.from_affine_ints(a, "cpu"), cd.from_affine_ints(b, "cpu")
    for x, y in zip(cd.add(A, B), curve.add_plain(A, B)):
        assert torch.equal(x, y)
    for x, y in zip(cd.double(A), curve.double_plain(A)):
        assert torch.equal(x, y)
    assert cd.is_identity(A).tolist() == [p is None for p in a]
    assert cd.to_affine_ints(cd.negate(A)) == [hc.g1_neg(p) for p in a]


def test_pack_and_unpack_rows_match_the_jax_package():
    pts = cd.from_affine_ints(_points(5) + [None], "cpu")
    packed = curve.pack_points_xy(pts[0], pts[1])
    ref = jcurve.pack_points_xy(*(jnp.asarray(c.numpy().astype(np.uint32)) for c in pts[:2]))
    np.testing.assert_array_equal(packed.numpy().view(np.uint32), np.asarray(ref))
    x, y = curve.unpack_xy_rows(packed)
    assert torch.equal(x, pts[0]) and torch.equal(y, pts[1])


def _host_bucket_sum(rows, entries):
    acc = None
    for e in entries:
        if e:
            p = rows[abs(e) - 1]
            acc = hc.g1_add(acc, p if e > 0 else hc.g1_neg(p))
    return acc


@pytest.mark.parametrize("exact", [False, True])
def test_bucket_fold_plain_sums_each_lane(exact):
    """Signed entries, empty slots, a lane of empties, a cap that is not a
    multiple of the sub-rows, and a repeated point in one sub-row: the fast
    fold flags that lane, the exact fold sums it."""
    rows = _points(40)
    table = curve.pack_points_xy(*cd.from_affine_ints(rows, "cpu")[:2])
    R = curve.FOLD_SUBROWS
    cap = R + 24
    lanes = 5
    lay = np.zeros((lanes, cap), np.int32)
    for b in range(lanes):  # distinct rows in a lane: no accidental P == Q
        lay[b, :40] = (RNG.permutation(40) + 1) * RNG.choice([-1, 1], size=40)
    lay[2] = 0
    lay[3, 4] = lay[3, 4 + R] = 7  # sub-row 4 adds P_7 to P_7
    got, flags = curve.bucket_fold_plain(table, torch.as_tensor(lay), exact)
    affs = cd.to_affine_ints(got)
    for b in range(lanes):
        if b == 3 and not exact:
            continue
        assert affs[b] == _host_bucket_sum(rows, lay[b].tolist()), b
    assert int(flags) == (0 if exact else 1)
    assert affs[2] is None


def test_normalize_batch_gives_affine_form():
    pts = _points(5) + [None]
    jac = curve.add_plain(cd.from_affine_ints(pts, "cpu"), cd.from_affine_ints(pts, "cpu"))
    x, y, z = cd.normalize_batch(jac)
    one = fq.ones(())
    assert all(torch.equal(zi, one) or bool((zi == 0).all()) for zi in z)
    assert cd.to_affine_ints_host((x, y, z)) == cd.to_affine_ints_host(jac)
    assert cd.to_affine_ints_host((x, y, z)) == [hc.g1_add(p, p) for p in pts]


def test_tree_reduce_add():
    """19 points: two fan-in-16 levels, the first padded with identities."""
    pts = _points(19)
    exp = None
    for p in pts:
        exp = hc.g1_add(exp, p)
    assert cd.to_affine_ints(cd.tree_reduce_add(cd.from_affine_ints(pts, "cpu"))) == [exp]
