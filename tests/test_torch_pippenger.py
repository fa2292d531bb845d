"""The port's classic Pippenger (ops/msm.py) and kernel 6's plain version on
the CPU.

Digits, bucket layouts and top-window shapes against the JAX package's
(`marlin_tpu.ops.msm`); the plain window combine against the JAX XLA twin
`_combine_windows` (affine points: the twin is Horner, the port a tree);
whole MSMs against the JAX `msm_pippenger` and the host Pippenger
(`host_curve.g1_msm`); the table budget of snark/kzg.py against the JAX
package's formula.  Inputs come from seeded numpy generators; points are
multiples of the generator computed on the host.  All comparisons are exact.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlin_tpu.fields import bls12_381 as JP
from marlin_tpu.ops import curve_device as jcd
from marlin_tpu.ops import fr as jfr
from marlin_tpu.ops import msm as jmsm
from marlin_tpu_torch.fields import bls12_381 as P
from marlin_tpu_torch.fields import host_curve as hc
from marlin_tpu_torch.ops import curve, fq, fr, msm
from marlin_tpu_torch.ops import curve_device as cd
from marlin_tpu_torch.ops.limbs import ints_to_limbs
from marlin_tpu_torch.snark import kzg

R = P.R_MODULUS
assert R == JP.R_MODULUS


def _scalars(rng, n, below=R):
    return [int.from_bytes(rng.bytes(40), "little") % below for _ in range(n)]


def _points(rng, n):
    return hc.g1_fixed_base_powers(hc.G1_GEN, [s or 1 for s in _scalars(rng, n, R - 1)])


def _canonical(scalars):
    return ints_to_limbs(scalars, 16).astype(np.int32).reshape(len(scalars), 16)


def _jax_point(pt):
    return tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in pt)


def _jacobian(aff, z):
    """The affine point (x, y) as (x z^2, y z^3, z): off affine form."""
    q = P.Q_MODULUS
    x, y = aff
    X, Y, Z = (fq.from_ints([v], "cpu") for v in (x * z * z % q, y * z * z * z % q, z))
    return X, Y, Z


def test_unsigned_digits_layouts_and_top_shape_equal_the_jax_package():
    rng = np.random.default_rng(40)
    scal = _canonical([0, 1, R - 1, R - 2] + _scalars(rng, 60))
    for c in (5, 10, 13):
        for w in range(-(-P.FR_BITS // c)):
            np.testing.assert_array_equal(
                msm._digits(torch.as_tensor(scal), c, w).numpy(), jmsm._digits_np(scal, c, w)
            )
        for n in (300, 16383, 65535):
            W = -(-P.FR_BITS // c)
            assert msm._classic_top_shape(n, c, W) == jmsm._classic_top_shape(n, c, W)
    # bucket 3 takes 40 of 200 entries and spills past cap = 8
    nb, cap = 16, 8
    d = rng.integers(0, nb, size=200)
    d[rng.choice(200, 40, replace=False)] = 3
    layout, spill = msm._window_layout_device(torch.as_tensor(d)[None], nb, cap)
    ref, ref_spill = jmsm._window_layout_device(jnp.asarray(d.astype(np.uint32)), nb, cap)
    np.testing.assert_array_equal(layout[0].T.reshape(-1).numpy() - 1, np.asarray(ref))
    assert int(spill) == int(ref_spill) > 0


@pytest.mark.parametrize("c, W", [(4, 1), (4, 2), (4, 5), (4, 26), (10, 1), (10, 3), (10, 26)])
def test_combine_windows_plain_equals_the_jax_xla_twin(c, W):
    """Window sums with identities among them (the first, and one inside)."""
    rng = np.random.default_rng(41 + W)
    ks = _scalars(rng, W, R - 1)
    sums = hc.g1_fixed_base_powers(hc.G1_GEN, [k + 1 for k in ks])
    for w in {0, W // 2} if W > 2 else ():
        sums[w] = None
    pts = cd.from_affine_ints(sums, "cpu")
    stacked = tuple(t[:, None] for t in pts)  # [W, 1, 24], as msm_pippenger stacks them
    got = cd.to_affine_ints(curve.combine_windows(stacked, c))
    want = jcd.to_affine_ints(jmsm._combine_windows(_jax_point(stacked), c))
    horner = None
    for w, s in enumerate(sums):
        horner = hc.g1_add(horner, hc.g1_mul(s, 1 << (c * w)) if s else None)
    assert got == want == [horner]


@pytest.fixture(scope="module")
def random_msm():
    """300 points with an identity and one point off affine form, seeded
    scalars with a zero, c = 5."""
    rng = np.random.default_rng(42)
    affs = _points(rng, 300)
    scalars = _scalars(rng, 300)
    scalars[5] = 0
    affs[9] = None
    pts = cd.from_affine_ints(affs, "cpu")
    jac = _jacobian(affs[17], 1234567)
    for t, j in zip(pts, jac):
        t[17] = j[0]
    return affs, scalars, pts


def test_msm_pippenger_equals_the_jax_package_and_the_host(random_msm):
    affs, scalars, pts = random_msm
    msm.pending_fold_flags()
    got = cd.to_affine_ints(msm.msm_pippenger(pts, fr.from_ints(scalars, "cpu"), c=5))
    assert not msm.fold_flags_fired()
    want = jcd.to_affine_ints(
        jmsm.msm_pippenger(_jax_point(pts), jfr.from_ints(scalars), c=5)
    )
    assert got == want == [hc.g1_msm(affs, scalars)]


def test_skewed_windows_and_a_duplicate_point_fire_the_flag_and_exact_is_exact():
    """560 points at c = 5 (cap 64: two slots per fold sub-row).  Every
    scalar shares its bits above window 0, so windows 1-50 overflow their
    bucket and take masked sums.  In window 0, points 0-40 have digit 1 and
    point 32 is point 0: sub-row 0 of bucket 1 adds P to P, so the fast fold
    flags it and the exact fold doubles.  Point 100 is the identity, point
    101 is off affine form."""
    rng = np.random.default_rng(43)
    n, c = 560, 5
    affs = _points(rng, n)
    affs[32] = affs[0]
    affs[100] = None
    high = _scalars(rng, 1, R >> c)[0] << c
    digits = rng.integers(2, 1 << c, size=n)
    digits[:41] = 1
    scalars = [(high + int(d)) % R for d in digits]
    assert all(s >> c == high >> c for s in scalars)
    pts = cd.from_affine_ints(affs, "cpu")
    for t, j in zip(pts, _jacobian(affs[101], 987654321)):
        t[101] = j[0]
    scal = fr.from_ints(scalars, "cpu")
    num_windows, nb, cap = msm._classic_shape(n, c)
    assert cap == 64 == 2 * curve.FOLD_SUBROWS

    msm.pending_fold_flags()
    fast = msm.msm_pippenger(pts, scal, c=c)
    assert msm.fold_flags_fired()
    exact = msm.msm_pippenger(pts, scal, c=c, exact=True)
    assert not msm.pending_fold_flags()
    want = hc.g1_msm(affs, scalars)
    assert cd.to_affine_ints(exact) == [want]
    assert cd.to_affine_ints(fast) != [want]


def test_pippenger_device_and_fixed_base_powers_equal_the_host():
    rng = np.random.default_rng(44)
    ks = _scalars(rng, 4, R - 1)
    powers = msm.fixed_base_powers(hc.G1_GEN, ks, "cpu")
    affs = cd.to_affine_ints(powers)
    assert affs == hc.g1_fixed_base_powers(hc.G1_GEN, ks)

    affs = _points(rng, 40) + [None]
    scalars = _scalars(rng, 41)
    pts = cd.from_affine_ints(affs, "cpu")
    scal16 = torch.as_tensor(_canonical(scalars))
    total, spill = msm.pippenger_device(pts, scal16, 6)
    assert int(spill) == 0
    assert cd.to_affine_ints(total) == [hc.g1_msm(affs, scalars)]


def test_msm_table_budget_gate_matches_the_jax_formula(monkeypatch):
    """`_ensure_msm_table` on an SRS of N powers on the card builds a table
    exactly where the JAX package's packed-table estimate is at most
    MARLIN_TPU_MSM_TABLE_MB (default 2400), and none with
    MARLIN_TPU_MSM_TABLE=0; the build itself is stubbed."""
    built = []
    monkeypatch.setattr(msm, "build_fixed_table", lambda pts, c: built.append(c) or ("table", c))
    monkeypatch.delenv("MARLIN_TPU_MSM_TABLE", raising=False)
    monkeypatch.delenv("MARLIN_TPU_MSM_TABLE_MB", raising=False)

    def srs(n):
        limbs = torch.zeros(1, fq.L, dtype=torch.int32).expand(n, fq.L)
        return types.SimpleNamespace(device=torch.device("cuda"), powers_of_g=(limbs,) * 3)

    fits = {}
    for log_n in range(10, 24):
        n = 1 << log_n
        c = jmsm._fixed_c(n)
        jax_mb = jmsm.fixed_table_windows(c) * n * 24 * 4 / 1e6
        assert kzg.msm_table_mb(n) == jax_mb
        fits[log_n] = kzg._ensure_msm_table(srs(n)) is not None
        assert fits[log_n] == (jax_mb <= 2400)
    assert fits[20] and not fits[21]
    assert len(built) == sum(fits.values())

    monkeypatch.setenv("MARLIN_TPU_MSM_TABLE_MB", "100")
    assert kzg._ensure_msm_table(srs(1 << 16)) is None
    monkeypatch.setenv("MARLIN_TPU_MSM_TABLE_MB", "2400")
    monkeypatch.setenv("MARLIN_TPU_MSM_TABLE", "0")
    assert kzg._ensure_msm_table(srs(1 << 16)) is None
    cached = srs(1 << 12)
    cached._msm_table = "built before"
    assert kzg._ensure_msm_table(cached) is None
    assert len(built) == sum(fits.values())
