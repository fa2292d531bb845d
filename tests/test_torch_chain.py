"""The table route's shared ladder over window rows, and round 2's `h_1` trim, on the CPU.

* `ops/msm.py::_shared_ladder` cuts each item's scalars into the fold's
  balanced signed digits and ladders c-bit digits over the table's window
  rows (csrc/chain.cu on the card, the plain ladder here).  Its sums are
  held against the JAX package's tail ladder (`scalar_mul_batch` over 255
  bits plus `tree_reduce_add`, marlin_tpu/ops/msm.py:980-996) and against
  the host MSM, as affine points: digits 0, negative digits, a carry into
  the top window, the scalars r - 1 and 0, and items of unequal length.
  The table is built on the host from a handful of powers at the 2^14
  prove's c = 10.
* `prover_second_round` of both packages, with a stubbed round-2 core that
  returns a padded `h_1` on a mixed-size mul domain: both cut it to
  mul_size - h (marlin_tpu/snark/prover.py:364-373).

Inputs come from seeded numpy generators; every comparison is exact.
"""

import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import marlin_tpu.snark.domains as jdomains
import marlin_tpu.snark.prover as jprover
import marlin_tpu_torch.snark.prover as tprover
from marlin_tpu.ops import curve_device as jcd
from marlin_tpu_torch.fields import bls12_381 as P
from marlin_tpu_torch.fields import host_curve as hc
from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import curve, fr, msm
from marlin_tpu_torch.ops import curve_device as cd

R = P.R_MODULUS
C = 10  # the 2^14 prove's window (msm._fixed_c(2^16))
N = 8
RNG = np.random.default_rng(60)


def _rand(n):
    return [int.from_bytes(RNG.bytes(40), "little") % R for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _table():
    """N powers k_i G and their fixed-base table rows 2^(c w) k_i G, on the host."""
    ks = [k or 1 for k in _rand(N)]
    W = msm.fixed_table_windows(C)
    rows = hc.g1_fixed_base_powers(hc.G1_GEN, [(k << (C * w)) % R for w in range(W) for k in ks])
    xy = cd.from_affine_ints(rows, "cpu")
    return rows[:N], msm.FixedBaseTable(curve.pack_points_xy(xy[0], xy[1]), C, W, N)


# a carry into the top window: window 24 holds 1023 (digit -1, carry 1) and
# the top window 1, so its digit is 2
CARRY = (1023 << 240) | (1 << 250) | 5
# (offset, scalars) items of unequal length: digits 0 (the scalar 5 fills
# window 0 alone), the zero scalar, r - 1, random scalars with negative digits
ITEMS = (
    ((0, (CARRY, 0, R - 1)),),
    ((3, (5,)), (4, None), (6, (0,))),
    ((1, None), (5, (R - 1, 7))),
)


def _items(case):
    out = []
    for off, ks in case:
        ks = list(ks) if ks is not None else _rand(3)
        out.append((off, ks))
    return out


def _shared(table, items):
    sums = msm._shared_ladder(table, [(off, fr.from_ints(ks, "cpu")) for off, ks in items])
    return cd.to_affine_ints_host(sums)


def test_the_items_cover_the_digit_cases():
    W = msm.fixed_table_windows(C)
    scal = torch.as_tensor(np.asarray([[k >> (16 * j) & 0xFFFF for j in range(16)]
                                       for k in (CARRY, R - 1, 5)], np.int32))
    d = msm._signed_digits(scal, C, W)
    assert int(d[W - 1, 0]) == 2 and int(d[W - 2, 0]) == -1  # the top window's carry
    assert bool((d[:, 1] < 0).any())  # r - 1 has negative digits
    assert bool((d[1:, 2] == 0).all()) and int(d[0, 2]) == 5  # digits 0
    assert int(d.abs().max()) <= 1 << (C - 1)


@pytest.mark.parametrize("case", range(len(ITEMS)))
def test_shared_ladder_equals_the_host_msm(case):
    powers, table = _table()
    items = _items(ITEMS[case])
    want = [hc.g1_msm(powers[off : off + len(ks)], ks) for off, ks in items]
    assert _shared(table, items) == want


def test_shared_ladder_equals_the_jax_tail_ladder():
    """The JAX package's tails: each item padded with identity points and
    zero scalars to one length, `scalar_mul_batch` over 255 bits, then
    `tree_reduce_add` per item."""
    powers, table = _table()
    items = _items(ITEMS[0]) + _items(ITEMS[2])
    longest = max(len(ks) for _, ks in items)
    pts, ks = [], []
    for off, k in items:
        pad = longest - len(k)
        pts += powers[off : off + len(k)] + [None] * pad
        ks += k + [0] * pad
    jpts = tuple(jnp.asarray(np.asarray(t).astype(np.uint32)) for t in cd.from_affine_ints(pts, "cpu"))
    limbs = jnp.asarray(np.asarray([[k >> (16 * j) & 0xFFFF for j in range(16)] for k in ks], np.uint32))
    muls = jcd.scalar_mul_batch(jpts, limbs, P.FR_BITS)
    want = []
    for t in range(len(items)):
        part = tuple(m[t * longest : (t + 1) * longest] for m in muls)
        s = jcd.tree_reduce_add(part)
        want += cd.affine_ints_from_raw(*(np.asarray(c).astype(np.int64) for c in s))
    assert _shared(table, items) == want


def test_shared_ladder_runs_one_c_bit_ladder(monkeypatch):
    """One scalar_mul call over every (window, point) pair of every item, at
    c bits; the join is a halving tree of adds (5 levels for 2 x 26 pairs)."""
    _, table = _table()
    calls, adds = [], []
    scalar_mul, add = curve.scalar_mul, cd.add

    def recording(points, limbs, num_bits=255):
        calls.append((points[0].shape[0], num_bits))
        return scalar_mul(points, limbs, num_bits)

    def counting(p, q):
        adds.append(p[0].shape[:-1])
        return add(p, q)

    monkeypatch.setattr(curve, "scalar_mul", recording)
    monkeypatch.setattr(cd, "add", counting)
    items = [(2, fr.from_ints(_rand(1), "cpu")), (7, fr.from_ints(_rand(1), "cpu"))]
    msm._shared_ladder(table, items)
    assert calls == [(2 * table.num_windows, C)]
    assert adds == [(16, 2), (8, 2), (4, 2), (2, 2), (1, 2)]


@pytest.mark.parametrize("c", [4, 10, 13])
def test_signed_digits_carry_through_windows_of_half(c):
    """Windows whose raw digit is exactly 2^(c-1) pass an incoming carry on
    (the running-max recoding): held against the JAX package's loop, and
    the digits add back up to the scalar."""
    from marlin_tpu.ops import msm as jmsm

    W = msm.fixed_table_windows(c)
    half = 1 << (c - 1)
    rng = np.random.default_rng(61 + c)
    pool = [half, half, half, half - 1, half + 1, 0, (1 << c) - 1]
    ks = [sum(int(rng.choice(pool)) << (c * w) for w in range(W)) % R for _ in range(64)]
    ks += [(half << c) | (half + 1), R - 1, 0]
    scal = np.asarray([[k >> (16 * j) & 0xFFFF for j in range(16)] for k in ks], np.int32)
    d = msm._signed_digits(torch.as_tensor(scal), c, W)
    np.testing.assert_array_equal(d.numpy(), jmsm._signed_digits_np(scal, c, W))
    assert [sum(int(d[w, i]) << (c * w) for w in range(W)) for i in range(len(ks))] == ks


def test_shared_ladder_digit_scalars_fit_c_bits():
    """The balanced digits of the 255-bit scalars need c bits at most."""
    scal = bi.from_mont(fr.CTX, fr.from_ints([R - 1, CARRY] + _rand(30), "cpu"))
    for c in (6, 10, 13):
        d = msm._signed_digits(scal, c, msm.fixed_table_windows(c))
        assert int(d.abs().max()).bit_length() <= c


# --------------------------------------------------------------------------
# round 2's h_1 trim


def _round2_state(h, x_size, za_len, mask_len, dev):
    """The fields of a prover state that prover_second_round reads before
    and after its round-2 core: numpy arrays for the JAX package (dev None),
    tensors on `dev` for the port."""
    arr = (lambda n: np.zeros((n,), np.int32)) if dev is None else (
        lambda n: torch.zeros((n,), dtype=torch.int64, device=dev))
    coeffs = (lambda n: np.zeros((n, 16), np.uint32)) if dev is None else (
        lambda n: torch.zeros((n, 16), dtype=torch.int32, device=dev))
    mat = SimpleNamespace(rows=arr(2), cols_reindexed=arr(2), vals=coeffs(2), nnz=2)
    state = SimpleNamespace(
        domain_h=SimpleNamespace(size=h, evaluate_vanishing_polynomial=lambda a: (pow(a, h, R) - 1) % R),
        domain_x=SimpleNamespace(size=x_size),
        index=SimpleNamespace(a=mat, b=mat, c=mat),
        mask_poly=SimpleNamespace(coeffs=coeffs(mask_len)),
        z_a_poly=SimpleNamespace(coeffs=coeffs(za_len)),
        z_b_poly=SimpleNamespace(coeffs=coeffs(za_len)),
        w_poly=SimpleNamespace(coeffs=coeffs(h)),
        x_poly=coeffs(x_size),
        zk_bound=1,
    )
    if dev is not None:
        state.device = dev
    return state


def _mixed_size(mul_size):
    """The smallest 3 * 2^k >= mul_size: a mul domain that is not a power of two."""
    size = 3
    while size < mul_size:
        size *= 2
    return size


@pytest.mark.parametrize("h, za_len", [(16, 18), (64, 66)])
def test_both_packages_trim_h1_on_a_mixed_mul_domain(monkeypatch, h, za_len):
    x_size, mask_len = 4, 3 * h
    mul_size = max(mask_len, h + 2 * za_len - 1, 2 * h + x_size + 2)
    n_mul = _mixed_size(mul_size)
    assert n_mul & (n_mul - 1) and n_mul - h > mul_size - h
    seen = {}

    def core(pkg, zeros):
        def stub(*args, h, x_size, n_mul):
            seen[pkg] = n_mul
            return zeros(h + 1), zeros(h - 1), zeros(n_mul - h)  # h_1 padded to the domain
        return stub

    monkeypatch.setattr(jdomains, "compute_size_of_domain", _mixed_size)
    monkeypatch.setattr(tprover, "compute_size_of_domain", _mixed_size)
    monkeypatch.setattr(jprover, "_round2_core", core("jax", lambda n: jnp.zeros((n, 16), jnp.uint32)))
    monkeypatch.setattr(tprover, "_round2_core",
                        core("torch", lambda n: torch.zeros((n, 16), dtype=torch.int32)))
    msg = SimpleNamespace(alpha=5, eta_a=1, eta_b=2, eta_c=3)
    jor, _ = jprover.prover_second_round(msg, _round2_state(h, x_size, za_len, mask_len, None), None)
    tor, _ = tprover.prover_second_round(msg, _round2_state(h, x_size, za_len, mask_len, "cpu"), None)
    assert seen == {"jax": n_mul, "torch": n_mul}
    assert jor["h_1"].coeffs.shape[0] == tor["h_1"].coeffs.shape[0] == mul_size - h
    assert jor["g_1"].coeffs.shape[0] == tor["g_1"].coeffs.shape[0] == h - 1
