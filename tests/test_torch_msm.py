"""The port's fixed-base table MSM (ops/msm.py) on the CPU.

Digits, capacities and bucket layouts against the JAX package's
(`marlin_tpu.ops.msm`), and whole MSMs — the fold, the scans, the top
window, the shared ladder, the flag and its exact rerun — against the host
Pippenger (`host_curve.g1_msm`) as affine points.  The table of the MSM
tests is built on the host (2^(c·w)·k·G for the seeded scalars k), since
the plain Fq inversion over thousands of points takes minutes on a CPU;
`build_fixed_table` itself is checked on a few points.  The job-size
quantum is lowered to 512 so that a tail job fits a small table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marlin_tpu.ops import msm as jmsm
from marlin_tpu_torch.fields import bls12_381 as P
from marlin_tpu_torch.fields import host_curve as hc
from marlin_tpu_torch.ops import curve, fq, fr, msm
from marlin_tpu_torch.ops import curve_device as cd
from marlin_tpu_torch.ops.limbs import ints_to_limbs
from marlin_tpu_torch.snark import kzg

RNG = np.random.default_rng(30)
R = P.R_MODULUS
C = 6
N = 672


def _scalars(n):
    return [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(n)]


def _canonical(scalars):
    return ints_to_limbs(scalars, 16).astype(np.int32).reshape(len(scalars), 16)


def test_signed_digits_windows_and_caps_equal_the_jax_package():
    scal = _canonical([0, 1, R - 1, R - 2] + _scalars(60))
    for c in (4, 6, 10, 13):
        W = msm.fixed_table_windows(c)
        assert W == jmsm.fixed_table_windows(c)
        np.testing.assert_array_equal(
            msm._signed_digits(torch.as_tensor(scal), c, W).numpy(),
            jmsm._signed_digits_np(scal, c, W),
        )
        for n_j in (512, 4096, 16384, 65536):
            assert msm._top_fold_shape(n_j, c, W) == jmsm._top_fold_shape(n_j, c, W)
    for log_n in range(10, 21):
        assert msm._fixed_c(1 << log_n) == jmsm._fixed_c(1 << log_n)


def test_merged_layouts_equal_the_jax_package():
    J, Wm, n, nb, cap = 2, 3, 50, 9, 32
    bucket = RNG.integers(0, nb, size=(J, Wm, n)).astype(np.int32)
    bucket[1, :, :30] = 4  # bucket 4 of job 1 spills
    enc = (RNG.integers(1, 1000, size=(J, Wm, n)) * RNG.choice([-1, 1], size=(J, Wm, n))).astype(np.int32)
    layouts, spill = msm._merged_layouts_batched(torch.as_tensor(bucket), torch.as_tensor(enc), nb, cap)
    ref, ref_spill = jmsm._merged_layouts_batched(jnp.asarray(bucket), jnp.asarray(enc), nb, cap)
    np.testing.assert_array_equal(layouts.transpose(1, 2).numpy(), np.asarray(ref))
    assert int(spill) == int(ref_spill) > 0


def test_build_fixed_table_rows_are_the_scaled_powers():
    ks = [k or 1 for k in _scalars(3)]
    pts = hc.g1_fixed_base_powers(hc.G1_GEN, ks)
    table = msm.build_fixed_table(cd.from_affine_ints(pts, "cpu"), C)
    W = table.num_windows
    x, y = curve.unpack_xy_rows(table.xy)
    got = cd.to_affine_ints_host((x, y, fq.ones((x.shape[0],))))
    scaled = [(k << (C * w)) % R for w in range(W) for k in ks]
    assert got == hc.g1_fixed_base_powers(hc.G1_GEN, scaled)


@pytest.fixture(scope="module")
def host_table():
    """N powers k_i·G (k_40 = k_10: a duplicate point) and their table at
    c = 6, built on the host."""
    ks = [k or 1 for k in _scalars(N)]
    ks[40] = ks[10]
    W = msm.fixed_table_windows(C)
    rows = hc.g1_fixed_base_powers(hc.G1_GEN, [(k << (C * w)) % R for w in range(W) for k in ks])
    pts = cd.from_affine_ints(rows, "cpu")
    table = msm.FixedBaseTable(curve.pack_points_xy(pts[0], pts[1]), C, W, N)
    return rows[:N], table


@pytest.fixture
def small_quantum(monkeypatch):
    monkeypatch.setattr(msm, "_FIXED_QUANT", 512)


def test_msm_fixed_many_equals_the_host_msm(host_table, small_quantum):
    """A full job (a zero scalar, the duplicate point), a shifted job in the
    same group, a job with a 5-point tail, and a 5-point job: two fold
    groups and one shared ladder."""
    powers, table = host_table
    specs = [(0, 600), (100, 520), (150, 517), (3, 5)]
    scalars = [_scalars(n) for _, n in specs]
    scalars[0][0] = 0
    jobs = [(off, fr.from_ints(s, "cpu")) for (off, _), s in zip(specs, scalars)]
    msm.pending_fold_flags()
    out = msm.msm_fixed_many(table, jobs)
    assert not msm.fold_flags_fired()
    got = cd.to_affine_ints_host(tuple(torch.cat([p[i] for p in out]) for i in range(3)))
    assert got == [hc.g1_msm(powers[off : off + n], s) for (off, n), s in zip(specs, scalars)]


def test_repeated_scalars_fire_the_flag_and_the_rerun_is_exact(host_table, small_quantum, monkeypatch):
    """Every scalar the same, with digit 1 in three windows: bucket 1 gets
    1800 entries against a capacity of 1576, the flag fires, and the
    commit path reruns the batch exactly with a raised capacity."""
    powers, table = host_table
    digits = [1, 1, 1] + [(w % 30) + 2 for w in range(3, table.num_windows - 1)]
    s = sum(d << (C * w) for w, d in enumerate(digits))
    scalars = [s] * 600
    monkeypatch.setattr(kzg, "_ensure_msm_table", lambda pp: table)
    monkeypatch.setattr(kzg, "_HOST_MSM_THRESHOLD", 0)
    pp = kzg.UniversalParams(cd.from_affine_ints(powers, "cpu"), None, None, None, None, None)
    ck = kzg.CommitterKey(pp, N - 1, [], None)
    reruns = kzg.STATS["exact_reruns"]
    msm.pending_fold_flags()
    got = kzg._run_msm_jobs(ck, [(0, fr.from_ints(scalars, "cpu"))])
    assert kzg.STATS["exact_reruns"] == reruns + 1
    assert got == [hc.g1_msm(powers[:600], scalars)]
