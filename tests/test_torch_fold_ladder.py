"""The bucket fold's sub-rows and the one-launch ladder (ops/curve.py) on the CPU.

* `fold_subrows` at the table path's and the classic path's fold shapes;
* the plain fold at 1, 4, 8 and 32 sub-rows against the JAX package's fold
  (8 rows a lane, `_fold_kernel` at marlin_tpu/ops/pallas/curve.py:320),
  run over its XLA group law (`curve_device._add_xla`) as
  tests/test_torch_curve.py runs it: the same affine sums, and the same
  count of degenerate fast madds, for a layout whose lane 3 meets P == Q;
* the plain `scalar_mul` against `marlin_tpu/ops/curve_device.py:282`
  `scalar_mul_batch` (affine points) and against the add-then-select loop
  it replaces (limb for limb), with identity points, scalar 0 and r - 1;
* the compile-time moduli of csrc/mont.cuh against the port's contexts.

Inputs come from seeded numpy generators; every comparison is exact.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlin_tpu.ops import curve_device as jcd
from marlin_tpu_torch.fields import bls12_381 as P
from marlin_tpu_torch.fields import host_curve as hc
from marlin_tpu_torch.ops import curve, fq, fr
from marlin_tpu_torch.ops import curve_device as cd
from marlin_tpu_torch.ops.limbs import ints_to_limbs

MONT_CUH = os.path.join(os.path.dirname(__file__), "..", "marlin_tpu_torch", "csrc", "mont.cuh")
JAX_ROWS = 8  # rows of the JAX fold's accumulator (pallas/curve.py _RT)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(40), "little") % (P.R_MODULUS - 1) + 1 for _ in range(n)]
    return hc.g1_fixed_base_powers(hc.G1_GEN, ks)


def _jax(pt):
    return tuple(jnp.asarray(np.asarray(c).astype(np.uint32)) for c in pt)


def _affine(pt):
    return cd.affine_ints_from_raw(*(np.asarray(c).astype(np.int64) for c in pt))


@pytest.mark.parametrize(
    "lanes, cap, want",
    [(1539, 3552, 32), (16384, 128, 2), (32768, 64, 1), (4096, 976, 8), (5, 56, 32),
     (100, 4, 4), (1, 0, 1)],
)
def test_fold_subrows_at_the_table_and_classic_shapes(lanes, cap, want):
    """The 2^14 prove's largest table fold keeps 32 sub-rows (one warp a
    lane); the classic path's [16384, 128] windows take 2; lanes that fill
    the card alone take 1; never more sub-rows than slots."""
    assert curve.fold_subrows(lanes, cap) == want
    assert curve.fold_subrows(1539, 3552) == curve.FOLD_SUBROWS


# --------------------------------------------------------------------------
# the fold


@functools.lru_cache(maxsize=None)
def _fold_case():
    """48 table points; 6 lanes of 40 slots holding distinct signed rows,
    lane 2 empty, lane 3 only P at slots 0 and 32 (one sub-row at every
    sub-row count, and one row of the JAX fold)."""
    rows = _points(48, 30)
    rng = np.random.default_rng(31)
    lanes, cap = 6, 40
    lay = np.zeros((lanes, cap), np.int32)
    for b in range(lanes):
        fill = int(rng.integers(cap // 2, cap + 1))
        lay[b, :fill] = (rng.permutation(48)[:fill] + 1) * rng.choice([-1, 1], size=fill)
    lay[2] = 0
    lay[3] = 0
    lay[3, 0] = lay[3, 32] = 13
    return rows, lay


@functools.lru_cache(maxsize=None)
def _jax_fold(exact: bool):
    """The JAX fold's order over the JAX group law: slot j of a lane goes
    to row j mod 8 (empty slots are the identity), the rows join by
    roll-halving complete adds.  A fast madd degenerates where the row's
    sum and the slot's point are the same point (H = 0 and r = 0): counted
    per (row, lane), as `_fold_kernel` ors its flags.  -> (affine lane sums,
    degenerate count)."""
    rows, lay = _fold_case()
    lanes, cap = lay.shape
    steps = -(-cap // JAX_ROWS)
    slots = np.zeros((lanes, steps * JAX_ROWS), np.int64)
    slots[:, :cap] = lay

    def step_points(t):  # [lanes * 8] points of step t, lane-major
        e = slots[:, t * JAX_ROWS : (t + 1) * JAX_ROWS].reshape(-1)
        return [None if v == 0 else rows[v - 1] if v > 0 else hc.g1_neg(rows[-v - 1]) for v in e]

    acc_aff = step_points(0)
    acc = _jax(cd.from_affine_ints(acc_aff, "cpu"))
    degenerate = 0
    for t in range(1, steps):
        nxt = step_points(t)
        if not exact:
            degenerate += sum(a is not None and a == p for a, p in zip(acc_aff, nxt))
        acc = jcd._add_xla(acc, _jax(cd.from_affine_ints(nxt, "cpu")))
        acc_aff = _affine(acc)
    acc = tuple(c.reshape(lanes, JAX_ROWS, -1) for c in acc)
    s = JAX_ROWS // 2
    while s >= 1:
        acc = jcd._add_xla(acc, tuple(jnp.roll(c, -s, axis=1) for c in acc))
        s //= 2
    return _affine(tuple(c[:, 0] for c in acc)), degenerate


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("subrows", [1, 4, 8, 32])
def test_bucket_fold_plain_equals_the_jax_fold(subrows, exact):
    rows, lay = _fold_case()
    table = curve.pack_points_xy(*cd.from_affine_ints(rows, "cpu")[:2])
    got, flags = curve.bucket_fold_plain(table, torch.as_tensor(lay), exact, subrows)
    want, degenerate = _jax_fold(exact)
    assert int(flags) == degenerate == (0 if exact else 1)
    affs = cd.to_affine_ints_host(got)
    for b in range(lay.shape[0]):
        if exact or b != 3:  # the fast fold's flagged lane holds no sum
            assert affs[b] == want[b], b
    assert affs[2] is None
    if exact:
        assert affs[3] == hc.g1_mul(rows[12], 2)


def test_bucket_fold_takes_the_shape_s_subrows():
    """Without a count, kernel and plain fold take `fold_subrows` of the
    layout's shape: here 4 (at most cap)."""
    rows, lay = _fold_case()
    table = curve.pack_points_xy(*cd.from_affine_ints(rows, "cpu")[:2])
    narrow = torch.as_tensor(lay[:, :4].copy())
    assert curve.fold_subrows(*narrow.shape) == 4
    got, _ = curve.bucket_fold(table, narrow)
    for g, w in zip(got, curve.bucket_fold_plain(table, narrow, subrows=4)[0]):
        assert torch.equal(g, w)


# --------------------------------------------------------------------------
# the ladder


@functools.lru_cache(maxsize=None)
def _ladder_case():
    """8 points (two identities, one off affine form) and scalars 0, 1,
    r - 1 (twice: on an identity and on a point) and random ones."""
    rng = np.random.default_rng(32)
    r, q = P.R_MODULUS, P.Q_MODULUS
    pts = _points(8, 33)
    pts[4] = pts[6] = None
    ks = [0, 1, r - 1, 5] + [int.from_bytes(rng.bytes(40), "little") % r for _ in range(4)]
    ks[6] = r - 1
    A = cd.from_affine_ints(pts, "cpu")
    z = 0x7654321
    x, y = pts[5]
    for t, v in zip(A, fq.from_ints([x * z * z % q, y * z**3 % q, z], "cpu")):
        t[5] = v
    scal = torch.as_tensor(ints_to_limbs(ks, fr.L).astype(np.int32))
    return pts, ks, A, scal, curve.scalar_mul_plain(A, scal, P.FR_BITS)


def test_scalar_mul_plain_equals_the_jax_ladder():
    pts, ks, A, scal, got = _ladder_case()
    want = jcd.scalar_mul_batch(_jax(A), jnp.asarray(scal.numpy().astype(np.uint32)), P.FR_BITS)
    assert cd.to_affine_ints_host(got) == _affine(want)
    assert cd.to_affine_ints_host(got) == [hc.g1_mul(p, k) if p else None for p, k in zip(pts, ks)]


def test_scalar_mul_plain_equals_the_host_loop_composition():
    """The loop the one-launch ladder replaces: double, add, select per bit."""
    _, _, A, scal, got = _ladder_case()
    acc = cd.identity((A[0].shape[0],), "cpu")
    for k in range(P.FR_BITS - 1, -1, -1):
        acc = cd.double(acc)
        bit = ((scal[:, k // 16] >> (k % 16)) & 1) == 1
        acc = cd.select_point(bit, cd.add(acc, A), acc)
    for g, w in zip(got, acc):
        assert torch.equal(g, w)


def test_scalar_mul_broadcasts_one_base_over_many_scalars():
    """fixed_base_powers' shape: one base point against a scalar per output."""
    from marlin_tpu_torch.ops import msm

    ks = [0, 1, 2, 3, P.R_MODULUS - 1, 12345]
    got = msm.fixed_base_powers(hc.G1_GEN, ks, "cpu")
    assert all(t.shape == (len(ks), fq.L) for t in got)
    assert cd.to_affine_ints(got) == hc.g1_fixed_base_powers(hc.G1_GEN, ks)


# --------------------------------------------------------------------------
# the kernels' compile-time moduli


@pytest.mark.parametrize("traits, ctx", [("FqTraits", fq.CTX), ("FrTraits", fr.CTX)])
def test_mont_header_moduli_match_the_field_contexts(traits, ctx):
    text = open(MONT_CUH).read()
    body = text[text.index(f"struct {traits} {{") :]
    body = body[: body.index("};")]
    nl = int(re.search(r"NL = (\d+);", body).group(1))
    bits = int(re.search(r"BITS = (\d+);", body).group(1))
    np0 = int(re.search(r"NP0 = (0x[0-9a-f]+)u;", body).group(1), 16)

    def limbs(fn):
        part = body[body.index(f"constexpr uint32_t {fn}(int j)") :]
        part = part[: part.index("}\n  }")]
        return sum(int(v, 16) << (32 * i) for i, v in enumerate(re.findall(r"return (0x[0-9a-f]+)u;", part)))

    assert 32 * nl == 16 * ctx.L and bits == ctx.modulus.bit_length()
    assert limbs("n") == ctx.modulus
    assert limbs("one") == ctx.mont_one
    assert limbs("r3") == pow(ctx.R, 3, ctx.modulus)
    assert np0 == (-pow(ctx.modulus, -1, 1 << 32)) % (1 << 32)
