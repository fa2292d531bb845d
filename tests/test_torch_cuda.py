"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips where no CUDA device is present.  On the H100
they run with (the suite's conftest imports JAX, which that machine lacks):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py

Exact equality throughout: the kernels and the plain versions compute the
same canonical residues.
"""

import functools

import numpy as np
import pytest
import torch

from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import cuda, fq, fr, ntt

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _elements(ctx, n, seed, dev):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(56), "little") % ctx.modulus for _ in range(n)]
    edges = [0, 1, ctx.modulus - 2, ctx.modulus - 1][:n]
    vals[: len(edges)] = edges
    mod = fr if ctx is fr.CTX else fq
    return mod.from_ints(vals, dev)


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("kind", ["mul", "add", "sub"])
def test_binop_kernel_matches_plain(dev, field, kind):
    ctx = {"fr": fr.CTX, "fq": fq.CTX}[field]
    a, b = _elements(ctx, 3000, 1, dev), _elements(ctx, 3000, 2, dev).flip(0)
    plain = {"mul": bi.mont_mul, "add": bi.add_mod, "sub": bi.sub_mod}[kind]
    assert torch.equal(bi.binop_kernel(kind, ctx, a, b), plain(ctx, a, b))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mul_kernel_takes_an_operand_below_r(dev, field):
    """to_mont of raw limbs: one operand any value below R, not below N."""
    ctx = {"fr": fr.CTX, "fq": fq.CTX}[field]
    rng = np.random.default_rng(21)
    raw = torch.as_tensor(rng.integers(0, 1 << 16, size=(3000, ctx.L)).astype(np.int32), device=dev)
    raw[0] = 0xFFFF  # R - 1
    b = _elements(ctx, 3000, 22, dev)
    assert torch.equal(bi.binop_kernel("mul", ctx, raw, b), bi.mont_mul(ctx, raw, b))
    assert torch.equal(bi.binop_kernel("mul", ctx, b, raw), bi.mont_mul(ctx, b, raw))


# kernel 2's cases: one element, a few, one block (128 threads) and more;
# 2^18 + 3 makes every thread take several elements (stride blockDim)
INV_SIZES = [1, 2, 7, 256, 4099, (1 << 18) + 3]


def _with_zeros(x, n):
    """Zeros at the first and last element of a thread's run, of a block
    (128 elements at one a thread) and of the whole batch."""
    for i in (0, 127, 128, 255, 4096, n - 1):
        if i < n:
            x[i] = 0
    return x


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("n", INV_SIZES)
def test_inv_kernel_matches_plain(dev, field, n):
    ctx = {"fr": fr.CTX, "fq": fq.CTX}[field]
    x = _with_zeros(_elements(ctx, n, 3, dev), n)
    cuda.reset_launches()
    got = bi.inv_kernel(ctx, x)
    assert cuda.LAUNCHES["field_inv"] == 1
    assert torch.equal(got, bi.inv_mod(ctx, x))
    zero = (x == 0).all(-1)
    assert bool((got[zero] == 0).all())
    one = torch.as_tensor(ctx.one_limbs.astype(np.int32), device=dev)
    assert bool((bi.binop_kernel("mul", ctx, x, got)[~zero] == one).all())


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_inv_kernel_maps_an_all_zero_batch_to_zero(dev, field):
    ctx = {"fr": fr.CTX, "fq": fq.CTX}[field]
    for n in (1, 300):
        x = torch.zeros((n, ctx.L), dtype=torch.int32, device=dev)
        assert bool((bi.inv_kernel(ctx, x) == 0).all())


@pytest.mark.parametrize("shape", [(2,), (1 << 10,), (1 << 13,), (3, 1 << 11)])
def test_ntt_kernels_match_plain_twins(dev, shape):
    x = _elements(fr.CTX, int(np.prod(shape)), 4, dev).reshape(*shape, fr.L)
    for inverse in (False, True):
        assert torch.equal(ntt.transform(x, inverse), ntt.transform(x, inverse, plain=True))


@pytest.mark.parametrize("log_n", range(1, 13))
def test_ntt_kernels_match_plain_at_each_block_size(dev, log_n):
    """Batched [3, 2^log_n] transforms, forward and inverse, at every
    in-block size the kernel takes; each is one block-stage launch plus one
    per group of wider stages, and no field product (the n^-1 rides in the
    gather)."""
    n = 1 << log_n
    x = _elements(fr.CTX, 3 * n, 30 + log_n, dev).reshape(3, n, fr.L)
    for log_b in range(1, min(log_n, ntt.BLOCK_LOG2) + 1):
        for inverse in (False, True):
            cuda.reset_launches()
            got = ntt.transform(x, inverse, block_log2=log_b)
            assert cuda.LAUNCHES["ntt_block_stages"] == 1
            assert cuda.LAUNCHES["ntt_cross_stage"] == len(ntt.cross_groups(log_n, log_b))
            assert cuda.LAUNCHES["field_binop"] == 0
            assert torch.equal(got, ntt.transform(x, inverse, plain=True, block_log2=log_b))


def test_ntt_block_stage_kernel_matches_plain_with_scale(dev):
    n = 1 << 12
    x = _elements(fr.CTX, 2 * n, 40, dev)
    tw, scale = ntt._plan_tensors(n, True, dev)
    for log_b in (1, 5, 10):
        for sc in (None, scale):
            assert torch.equal(ntt.block_stages_kernel(x, tw, log_b, 12, sc),
                               ntt.block_stages_plain(x, tw, log_b, 12, sc))


# kernel 1's broadcast operands, read in place through their row maps:
# (a shape, b shape), as tests/test_torch_binop_cross.py plans them
BROADCASTS = [((3000,), (1,)), ((1,), (3000,)), ((3, 1000), (1, 1000)), ((40, 1), (40, 75)),
              ((1, 1, 9, 128), (9, 9, 1)), ((2, 9, 128), (9, 128)), ((), (77,))]


@pytest.mark.parametrize("staged", [False, True], ids=["direct", "staged"])
@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("shapes", BROADCASTS, ids=[f"{a}x{b}" for a, b in BROADCASTS])
def test_binop_kernel_reads_broadcast_operands_in_place(dev, shapes, field, staged):
    ctx = {"fr": fr.CTX, "fq": fq.CTX}[field]
    sa, sb = shapes
    a = _elements(ctx, int(np.prod(sa)), 11, dev).reshape(*sa, ctx.L)
    b = _elements(ctx, int(np.prod(sb)), 12, dev).reshape(*sb, ctx.L)
    for kind, plain in (("mul", bi.mont_mul), ("add", bi.add_mod), ("sub", bi.sub_mod)):
        cuda.reset_launches()
        got = bi.binop_kernel(kind, ctx, a, b, staged=staged)
        assert cuda.BINOP_COPIES == {"broadcast": 0, "layout": 0}
        assert torch.equal(got, plain(ctx, a, b))


@pytest.mark.parametrize("staged", [False, True], ids=["direct", "staged"])
@pytest.mark.parametrize("n", [1, 31, 32, 4096, 4097, 1 << 14, (1 << 16) + 5])
def test_binop_kernel_bodies_at_each_grid_size(dev, n, staged):
    """Both bodies at a one-warp block, a ragged last tile, the prove's
    [4096, 16] and 2^14, and a grid that loops over several tiles."""
    a, b = _elements(fr.CTX, n, 13, dev), _elements(fr.CTX, n, 14, dev).flip(0)
    for kind, plain in (("mul", bi.mont_mul), ("sub", bi.sub_mod)):
        assert torch.equal(bi.binop_kernel(kind, fr.CTX, a, b, staged=staged), plain(fr.CTX, a, b))


def test_binop_kernel_counts_a_materialized_broadcast(dev):
    a = _elements(fr.CTX, 6, 15, dev).reshape(2, 1, 3, fr.L)
    b = _elements(fr.CTX, 30, 16, dev).reshape(2, 5, 3, fr.L)
    cuda.reset_launches()
    assert torch.equal(bi.binop_kernel("mul", fr.CTX, a, b), bi.mont_mul(fr.CTX, a, b))
    assert cuda.BINOP_COPIES == {"broadcast": 1, "layout": 0}


@pytest.mark.parametrize("log_n, log_b", [(12, 3), (13, 4), (16, 10), (17, 10), (20, 10)])
def test_cross_stages_kernel_matches_plain_in_each_group(dev, log_n, log_b):
    """Kernel 3(b) over each group of its plan, split (2^12 and 2^13 with a
    small block, 2^20) or whole, against the plain stages."""
    n = 1 << log_n
    x = _elements(fr.CTX, 2 * n if log_n < 20 else n, 50 + log_n, dev)
    tw, _ = ntt._plan_tensors(n, True, dev)
    groups = ntt.cross_groups(log_n, log_b)
    assert len(groups) == (1 if log_n in (16, 17) else 2)
    for s0, s1 in groups:
        cuda.reset_launches()
        got = ntt.cross_stages_kernel(x.clone(), tw, s0, s1)
        assert cuda.LAUNCHES["ntt_cross_stage"] == 1
        assert torch.equal(got, ntt.cross_stages_plain(x, tw, s0, s1))


def test_cuda_routing_counts_launches(dev):
    cuda.reset_launches()
    x = _elements(fr.CTX, 64, 5, dev)
    fr.inv(fr.mul(x, x))
    ntt.ntt(x, 1 << 11)
    assert cuda.LAUNCHES["field_binop"] >= 1 and cuda.LAUNCHES["field_inv"] == 1
    assert cuda.LAUNCHES["ntt_block_stages"] == 1 and cuda.LAUNCHES["ntt_cross_stage"] == 1


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_field_helpers_on_the_card_match_plain(dev, field):
    """The helpers of ops/fr.py and ops/fq.py on CUDA tensors (kernel 1
    where they multiply or subtract) against their plain versions on the
    same limbs on the CPU."""
    mod = {"fr": fr, "fq": fq}[field]
    a = _elements(mod.CTX, 3000, 61, dev)
    b = a.flip(0).clone()
    b[7] = a[7]
    cond = torch.arange(3000, device=dev) % 3 == 0
    cuda.reset_launches()
    cpu = [t.cpu() for t in (a, b, cond)]
    assert torch.equal(mod.neg(a).cpu(), mod.neg(cpu[0]))
    assert torch.equal(mod.sqr(a).cpu(), bi.mont_mul(mod.CTX, cpu[0], cpu[0]))
    assert torch.equal(mod.is_zero(a).cpu(), bi.is_zero(mod.CTX, cpu[0]))
    assert torch.equal(mod.eq(a, b).cpu(), bi.eq(mod.CTX, cpu[0], cpu[1]))
    assert torch.equal(mod.select(cond, a, b).cpu(), bi.select(cpu[2], cpu[0], cpu[1]))
    if field == "fr":
        for e in (0, 5, fr.CTX.modulus - 2):
            bits = [int(c) for c in bin(e)[2:]]
            assert torch.equal(fr.pow_const(a[:64], e).cpu(), bi.pow_const(fr.CTX, cpu[0][:64], bits))
    assert cuda.LAUNCHES["field_binop"] > 0


def test_poly_helpers_on_the_card_match_plain(dev):
    from marlin_tpu_torch.ops import poly

    p = _elements(fr.CTX, 1000, 62, dev)
    zs = list(_elements(fr.CTX, 3, 63, dev).unbind(0))
    got = poly.evaluate_many(p, zs)
    want = poly.evaluate_many(p.cpu(), [z.cpu() for z in zs])
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    padded = torch.cat([p, fr.zeros((5,), dev)])
    assert poly.degree(padded) == poly.degree(padded.cpu()) == 999


def _curve_points(n, seed, dev):
    from marlin_tpu_torch.fields import bls12_381 as P
    from marlin_tpu_torch.fields import host_curve as hc

    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(40), "little") % (P.R_MODULUS - 1) + 1 for _ in range(n)]
    return hc.g1_fixed_base_powers(hc.G1_GEN, ks)


def test_g1_add_and_double_kernels_match_plain(dev):
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd

    p = _curve_points(300, 6, dev)
    a = p[:200] + [p[0], p[1], None, p[2], None]
    b = p[100:300] + [p[0], hc.g1_neg(p[1]), p[3], None, None]
    A, B = cd.from_affine_ints(a, dev), cd.from_affine_ints(b, dev)
    S = curve.add_kernel(A, B)
    for k, q in zip(S, curve.add_plain(A, B)):
        assert torch.equal(k, q)
    for k, q in zip(curve.add_kernel(S, A), curve.add_plain(S, A)):  # Z != 1
        assert torch.equal(k, q)
    for k, q in zip(curve.double_kernel(S), curve.double_plain(S)):
        assert torch.equal(k, q)
    assert cd.to_affine_ints(S) == [hc.g1_add(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("exact", [False, True])
def test_bucket_fold_kernel_matches_plain(dev, exact):
    """Signed and empty slots, an empty lane, and a P + P in one sub-row
    (the fast fold flags it)."""
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd

    rows = cd.from_affine_ints(_curve_points(300, 7, dev), dev)
    table = curve.pack_points_xy(rows[0], rows[1])
    rng = np.random.default_rng(8)
    lanes, cap = 37, 3 * curve.FOLD_SUBROWS + 8
    lay = np.zeros((lanes, cap), np.int32)
    for b in range(lanes):
        fill = int(rng.integers(0, cap))
        lay[b, :fill] = (rng.permutation(300)[:fill] + 1) * rng.choice([-1, 1], size=fill)
    lay[5] = 0
    lay[9, 2] = lay[9, 2 + curve.FOLD_SUBROWS] = 11
    layout = torch.as_tensor(lay, device=dev)
    k_pts, k_flag = curve.bucket_fold_kernel(table, layout, exact)
    p_pts, p_flag = curve.bucket_fold_plain(table, layout, exact)
    for k, q in zip(k_pts, p_pts):
        assert torch.equal(k, q)
    assert int(k_flag) == int(p_flag) == (0 if exact else 1)


@pytest.mark.parametrize("subrows", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("exact", [False, True])
def test_bucket_fold_kernel_matches_plain_at_each_subrow_count(dev, subrows, exact):
    """Lane 9 holds one point twice (slots 0 and 32, nothing between), so
    the pair meets in one sub-row at every sub-row count."""
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd

    rows = cd.from_affine_ints(_curve_points(300, 15, dev), dev)
    table = curve.pack_points_xy(rows[0], rows[1])
    rng = np.random.default_rng(16)
    lanes, cap = 45, 77
    lay = np.zeros((lanes, cap), np.int32)
    for b in range(lanes):
        fill = int(rng.integers(0, cap))
        lay[b, :fill] = (rng.permutation(300)[:fill] + 1) * rng.choice([-1, 1], size=fill)
    lay[9] = 0
    lay[9, 0] = lay[9, 32] = -23
    layout = torch.as_tensor(lay, device=dev)
    k_pts, k_flag = curve.bucket_fold_kernel(table, layout, exact, subrows)
    p_pts, p_flag = curve.bucket_fold_plain(table, layout, exact, subrows)
    for k, q in zip(k_pts, p_pts):
        assert torch.equal(k, q)
    assert int(k_flag) == int(p_flag) == (0 if exact else 1)


def test_bucket_fold_kernel_takes_the_shape_s_subrows(dev):
    """Many short lanes (the classic path's shape, scaled down): the
    default sub-row count is the plain version's."""
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd

    rows = cd.from_affine_ints(_curve_points(200, 17, dev), dev)
    table = curve.pack_points_xy(rows[0], rows[1])
    rng = np.random.default_rng(18)
    lanes, cap = 20000, 8
    lay = (rng.integers(1, 201, size=(lanes, cap)) * rng.choice([-1, 0, 1], size=(lanes, cap)))
    layout = torch.as_tensor(lay.astype(np.int32), device=dev)
    assert curve.fold_subrows(lanes, cap) == 2
    k_pts, k_flag = curve.bucket_fold_kernel(table, layout)
    p_pts, p_flag = curve.bucket_fold_plain(table, layout)
    for k, q in zip(k_pts, p_pts):
        assert torch.equal(k, q)
    assert int(k_flag) == int(p_flag)


def test_scalar_mul_kernel_matches_plain(dev):
    """Identity points, scalars 0, 1 and r - 1, a point off affine form, and
    one base broadcast against many scalars; one launch each."""
    from marlin_tpu_torch.fields import bls12_381 as P
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops.limbs import ints_to_limbs

    rng = np.random.default_rng(19)
    r = P.R_MODULUS
    pts = _curve_points(40, 20, dev)
    pts[3] = pts[11] = None
    ks = [int.from_bytes(rng.bytes(40), "little") % r for _ in pts]
    ks[0], ks[1], ks[2], ks[3] = 0, 1, r - 1, r - 1
    A = cd.from_affine_ints(pts, dev)
    A = curve.add_kernel(A, A)  # Z != 1: the points 2 P_i
    scal = torch.as_tensor(ints_to_limbs(ks, 16).astype(np.int32), device=dev)
    cuda.reset_launches()
    got = curve.scalar_mul_kernel(A, scal)
    assert cuda.LAUNCHES["g1_scalar_mul"] == 1
    for k, q in zip(got, curve.scalar_mul_plain(A, scal)):
        assert torch.equal(k, q)
    want = [hc.g1_mul(hc.g1_add(p, p), k) if p else None for p, k in zip(pts, ks)]
    assert cd.to_affine_ints(got) == want
    base = cd.from_affine_ints([pts[5]], dev)
    wide = curve.scalar_mul_kernel(base, scal[:, None, :].expand(40, 3, 16), 255)
    for k, q in zip(wide, curve.scalar_mul_plain(base, scal[:, None, :].expand(40, 3, 16), 255)):
        assert k.shape == (40, 3, 24) and torch.equal(k, q)


def test_table_msm_on_the_card_equals_the_host_msm(dev):
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops import msm

    pts = _curve_points(700, 9, dev)
    table = msm.build_fixed_table(cd.from_affine_ints(pts, dev), 6)
    rng = np.random.default_rng(10)
    specs = [(0, 600), (100, 520), (3, 5)]
    r = msm.P.R_MODULUS
    scalars = [[int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)] for _, n in specs]
    jobs = [(off, fr.from_ints(s, dev)) for (off, _), s in zip(specs, scalars)]
    msm.pending_fold_flags()
    out = msm.msm_fixed_many(table, jobs)
    assert not msm.fold_flags_fired()
    got = cd.to_affine_ints_host(tuple(torch.cat([p[i] for p in out]) for i in range(3)))
    assert got == [hc.g1_msm(pts[off : off + n], s) for (off, n), s in zip(specs, scalars)]


def test_curve_kernels_count_launches(dev):
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd

    p = cd.from_affine_ints(_curve_points(8, 11, dev), dev)
    table = curve.pack_points_xy(p[0], p[1])
    cuda.reset_launches()
    cd.add(p, p)
    cd.double(p)
    curve.bucket_fold(table, torch.tensor([[1, -2, 0, 3]], dtype=torch.int32, device=dev))
    assert cuda.LAUNCHES["g1_add"] == 1 and cuda.LAUNCHES["g1_double"] == 1
    assert cuda.LAUNCHES["bucket_fold"] == 1
    cd.scalar_mul_batch(p, torch.ones((8, 16), dtype=torch.int32, device=dev))
    assert cuda.LAUNCHES["g1_scalar_mul"] == 1
    assert cuda.LAUNCHES["g1_add"] == 1 and cuda.LAUNCHES["g1_double"] == 1


@pytest.mark.parametrize("c, W", [(10, 26), (2, 128)])
def test_combine_windows_kernel_matches_plain(dev, c, W):
    """Jacobian window sums (Z != 1) with identities among them."""
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd

    p = _curve_points(2 * W, 12, dev)
    S = curve.add_kernel(cd.from_affine_ints(p[:W], dev), cd.from_affine_ints(p[W:], dev))
    for t, i in zip(S, cd.identity((2,), dev)):
        t[torch.as_tensor([0, W // 2], device=dev)] = i
    stacked = tuple(t[:, None].contiguous() for t in S)
    cuda.reset_launches()
    got = curve.combine_windows_kernel(stacked, c)
    assert cuda.LAUNCHES["combine_windows"] == 1
    for k, q in zip(got, curve.combine_windows_plain(stacked, c)):
        assert torch.equal(k, q)
    sums = [None if w in (0, W // 2) else hc.g1_add(p[w], p[W + w]) for w in range(W)]
    want = None
    for w, s in enumerate(sums):
        want = hc.g1_add(want, hc.g1_mul(s, 1 << (c * w)) if s else None)
    assert cd.to_affine_ints(got) == [want]


def test_public_msm_on_the_card_equals_the_host_msm(dev):
    """Random scalars; 16 points repeated (the fast fold meets P == Q and
    msm() reruns exactly); an identity and a point off affine form."""
    from marlin_tpu_torch.fields import bls12_381 as P
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops import msm

    rng = np.random.default_rng(13)
    r, q = P.R_MODULUS, P.Q_MODULUS
    base = _curve_points(1500, 14, dev)
    cases = {
        "random": base,
        "duplicates": [base[i % 16] for i in range(2048)],
        "identity_and_jacobian": base[:1200] + [None],
    }
    for name, affs in cases.items():
        scal = [int.from_bytes(rng.bytes(40), "little") % r for _ in affs]
        pts = cd.from_affine_ints(affs, dev)
        if name == "identity_and_jacobian":
            z = 0x1234567
            x, y = affs[7]
            for t, v in zip(pts, fq.from_ints([x * z * z % q, y * z**3 % q, z], dev)):
                t[7] = v
        cuda.reset_launches()
        got = cd.to_affine_ints(msm.msm(pts, fr.from_ints(scal, dev)))
        assert got == [hc.g1_msm(affs, scal)], name
        assert cuda.LAUNCHES["combine_windows"] == (2 if name == "duplicates" else 1), name


# --------------------------------------------------------------------------
# the chain kernels (csrc/chain.cu)


def test_chain_ladder_matches_plain_with_its_rare_branches(dev):
    """Raw 255-bit scalars whose last add meets P == Q (r + 2: the ladder
    holds (r + 1) P = P before it) and P == -Q (r: it holds -P); identity
    points, the scalars 0, 1 and r - 1, a point off affine form; 37 points,
    so a block's last warp holds a partial group of points."""
    from marlin_tpu_torch.fields import bls12_381 as P
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops.limbs import ints_to_limbs

    rng = np.random.default_rng(40)
    r, q = P.R_MODULUS, P.Q_MODULUS
    pts = _curve_points(37, 41, dev)
    pts[6] = None
    ks = [r + 2, r, 0, 1, r - 1, 5, r - 1] + [int.from_bytes(rng.bytes(40), "little") % r for _ in range(30)]
    A = cd.from_affine_ints(pts, dev)
    z = 0x3456789
    x, y = pts[8]
    for t, v in zip(A, fq.from_ints([x * z * z % q, y * z**3 % q, z], dev)):
        t[8] = v
    scal = torch.as_tensor(ints_to_limbs(ks, 16).astype(np.int32), device=dev)
    cuda.reset_launches()
    got = curve.scalar_mul_kernel(A, scal, P.FR_BITS)
    assert cuda.LAUNCHES["g1_scalar_mul"] == 1
    for k, p in zip(got, curve.scalar_mul_plain(A, scal, P.FR_BITS)):
        assert torch.equal(k, p)
    assert cd.to_affine_ints(got) == [hc.g1_mul(p, k % r) if p else None for p, k in zip(pts, ks)]
    # c-bit digits: the table route's launches
    short = curve.scalar_mul_kernel(A, scal, 10)
    for k, p in zip(short, curve.scalar_mul_plain(A, scal, 10)):
        assert torch.equal(k, p)


@pytest.mark.parametrize("c, W", [(0, 8), (1, 5), (10, 26), (2, 64), (2, 65), (1, 128), (7, 1)])
def test_chain_combine_matches_plain_with_its_rare_branches(dev, c, W):
    """Window sums with identities, and pairs that the tree's first level
    joins equal (P == Q at c = 0) or opposite (P == -Q); W past 64 gives a
    group two windows."""
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd

    p = _curve_points(2 * W, 42 + W, dev)
    sums = [hc.g1_add(a, b) for a, b in zip(p[:W], p[W:])]
    half = max(1, (1 << (W - 1).bit_length()) >> 1)  # the tree's first level: w takes w + half
    for w in range(half, W):
        sums[w] = [sums[w - half], hc.g1_neg(sums[w - half]), None][(w - half) % 3]
    S = cd.from_affine_ints(sums, dev)
    stacked = tuple(t[:, None].contiguous() for t in S)
    cuda.reset_launches()
    got = curve.combine_windows_kernel(stacked, c)
    assert cuda.LAUNCHES["combine_windows"] == 1
    for k, q in zip(got, curve.combine_windows_plain(stacked, c)):
        assert torch.equal(k, q)
    want = None
    for w, s in enumerate(sums):
        want = hc.g1_add(want, hc.g1_mul(s, 1 << (c * w)) if s else None)
    assert cd.to_affine_ints(got) == [want]


def test_shared_ladder_on_the_card_matches_its_plain_run(dev):
    """The table route's shared ladder over c-bit digits: one ladder launch
    of c bits, limb for limb against the plain run on a CPU copy of the
    table, and the host MSM as affine points."""
    from marlin_tpu_torch.fields import bls12_381 as P
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops import msm

    r = P.R_MODULUS
    pts = _curve_points(12, 43, dev)
    table = msm.build_fixed_table(cd.from_affine_ints(pts, dev), 10)
    cpu_table = msm.FixedBaseTable(table.xy.cpu(), table.c, table.num_windows, table.n_base)
    rng = np.random.default_rng(44)
    items = [(0, [r - 1, 0, 5]), (3, [int.from_bytes(rng.bytes(40), "little") % r]), (9, [0]),
             (10, [int.from_bytes(rng.bytes(40), "little") % r, r - 2])]
    cuda.reset_launches()
    got = msm._shared_ladder(table, [(off, fr.from_ints(ks, dev)) for off, ks in items])
    assert cuda.LAUNCHES["g1_scalar_mul"] == 1
    plain = msm._shared_ladder(cpu_table, [(off, fr.from_ints(ks, "cpu")) for off, ks in items])
    for k, p in zip(got, plain):
        assert torch.equal(k.cpu(), p)
    assert cd.to_affine_ints(got) == [hc.g1_msm(pts[off : off + len(ks)], ks) for off, ks in items]


# --------------------------------------------------------------------------
# the field entries refuse a context that is not the compiled one


def _foreign_contexts():
    """Contexts the library of the active curve must refuse: another modulus
    of the same width for each field (Fr's width 8 is where the entries once
    picked the traits by width alone), the other field's id with the right
    modulus, and the right words under another curve's number."""
    from marlin_tpu_torch.fields import bn254, bls12_377

    other = bls12_377 if fr.CTX.curve == "bn254" else bn254
    foreign_fq = other.Q_MODULUS if fq.L == other.FQ_BYTES // 2 else bls12_377.Q_MODULUS
    if foreign_fq == fq.CTX.modulus:
        foreign_fq = bn254.Q_MODULUS if fq.L == 16 else bls12_377.Q_MODULUS
    wrong_curve = next(c for c in cuda.CURVE_IDS if c != fr.CTX.curve)
    return [
        ("fr, another modulus", bi.ModCtx("fr", other.R_MODULUS, fr.L, fr.CTX.curve)),
        ("fq, another modulus", bi.ModCtx("fq", foreign_fq, fq.L, fq.CTX.curve)),
        ("fq's id, fr's modulus", bi.ModCtx("fq", fr.CTX.modulus, fr.L, fr.CTX.curve)),
        ("fr, another curve", bi.ModCtx("fr", fr.CTX.modulus, fr.L, wrong_curve)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_field_entries_refuse_a_foreign_context(dev, case):
    label, ctx = _foreign_contexts()[case]
    x = torch.ones((64, ctx.L), dtype=torch.int32, device=dev)
    for kind in ("mul", "add", "sub"):
        with pytest.raises(RuntimeError, match="cudaError"):
            bi.binop_kernel(kind, ctx, x, x)
    with pytest.raises(RuntimeError, match="cudaError"):
        bi.inv_kernel(ctx, x)
    torch.cuda.synchronize()


def test_library_names_the_active_curve(dev):
    lib = cuda.lib()
    assert lib.marlin_curve_id().decode() == fr.CTX.curve == cuda.active_curve()
    assert cuda.lib_path().endswith(f"{fr.CTX.curve}/libmarlin_cuda.so")


# --------------------------------------------------------------------------
# a mesh of distinct cards: each shard's kernels launch on its own card


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_a_mesh_of_distinct_cards_gives_the_one_card_results(two_cards, monkeypatch):
    """The four-step NTTs, the three MSM bodies (the ladder at 2^10 points,
    window blocks at 2^12, point shards at 2^15) and a 2^10-constraint prove
    over [cuda:0, cuda:1] equal the transform, the MSM and the proof bytes
    on cuda:0 alone."""
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops import msm
    from marlin_tpu_torch.parallel import context as pctx
    from marlin_tpu_torch.parallel import msm_sharded, ntt_sharded
    from marlin_tpu_torch.parallel.multihost import make_mesh
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.snark.r1cs import lc
    from marlin_tpu_torch.utils.rand import test_rng as seeded_rng

    mesh = make_mesh(devices=two_cards)
    home = two_cards[0]
    x = _elements(fr.CTX, 1 << 12, 5, home)
    for inverse in (False, True):
        want = ntt.transform(x, inverse)
        assert torch.equal(ntt_sharded.ntt_4step(x, mesh, inverse=inverse), want)
        assert torch.equal(ntt_sharded.ntt_4step_resident(x, mesh, inverse=inverse), want)

    rng = np.random.default_rng(6)
    r = fr.CTX.modulus
    pts = msm.fixed_base_powers(hc.G1_GEN, [int.from_bytes(rng.bytes(40), "little") % r for _ in range(1 << 15)], home)
    for n in (1 << 10, 1 << 12, 1 << 15):
        s = fr.from_ints([int.from_bytes(rng.bytes(40), "little") % r for _ in range(n)], home)
        part = tuple(c[:n] for c in pts)
        want = cd.to_affine_ints(msm.msm(part, s))
        assert cd.to_affine_ints(msm_sharded.msm_sharded(part, s, mesh)) == want

    class Circuit:  # x*y = out, repeated
        def generate_constraints(self, cs):
            a = cs.new_witness_variable(lambda: 11)
            b = cs.new_witness_variable(lambda: 13)
            c = cs.new_input_variable(lambda: 143)
            for _ in range((1 << 10) - 1):
                cs.enforce_constraint(lc(a), lc(b), lc(c))

    monkeypatch.setattr(pctx, "NTT_MIN_SHARDED", 1 << 8)
    monkeypatch.setattr(pctx, "MSM_MIN_SHARDED", 1 << 8)
    srs = Marlin.universal_setup(1 << 10, 1 << 10, 3 << 10, seeded_rng())
    pk, vk = Marlin.index(srs, Circuit())
    single = Marlin.prove(pk, Circuit(), seeded_rng())
    sharded = Marlin.prove(pk, Circuit(), seeded_rng(), mesh=mesh)
    assert sharded.to_bytes() == single.to_bytes()
    assert Marlin.verify(vk, [143], sharded, seeded_rng())


# --------------------------------------------------------------------------
# the other curves, each in a process of its own (the curve is chosen once
# a process): kernels 1 and 2 at both fields, and kernels 3-6 at small
# shapes, each against its plain version

_CURVE_PROG = r"""
import numpy as np, torch
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.fields import host_curve as hc
from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import cuda, curve, fq, fr, msm, ntt
from marlin_tpu_torch.ops import curve_device as cd
from marlin_tpu_torch.ops.limbs import ints_to_limbs

assert P.CURVE_NAME == CURVE and cuda.lib().marlin_curve_id().decode() == CURVE
dev = torch.device("cuda")
rng = np.random.default_rng(5)

def elements(mod, n):
    ctx = mod.CTX
    vals = [int.from_bytes(rng.bytes(56), "little") % ctx.modulus for _ in range(n)]
    vals[:4] = [0, 1, ctx.modulus - 2, ctx.modulus - 1]
    return mod.from_ints(vals, dev)

def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else torch.equal(a, b)

for mod in (fr, fq):
    ctx = mod.CTX
    a, b = elements(mod, 3000), elements(mod, 3000).flip(0)
    for kind, plain in (("mul", bi.mont_mul), ("add", bi.add_mod), ("sub", bi.sub_mod)):
        assert same(bi.binop_kernel(kind, ctx, a, b), plain(ctx, a, b)), (ctx.name, kind)
    raw = torch.as_tensor(rng.integers(0, 1 << 16, size=(3000, ctx.L)).astype(np.int32), device=dev)
    assert same(bi.binop_kernel("mul", ctx, raw, b), bi.mont_mul(ctx, raw, b)), (ctx.name, "a < R")
    for n in (1, 7, 4099):
        x = elements(mod, n)
        if n > 128:
            x[127] = 0
        got = bi.inv_kernel(ctx, x)
        assert same(got, bi.inv_mod(ctx, x)), (ctx.name, "inv", n)
        zero = (x == 0).all(-1)
        one = torch.as_tensor(ctx.one_limbs.astype(np.int32), device=dev)
        assert bool((bi.binop_kernel("mul", ctx, x, got)[~zero] == one).all()), (ctx.name, "x/x", n)
    print(ctx.name, "binop and inv ok", flush=True)

def has_domain(n):
    from marlin_tpu_torch.snark.domains import domain_of_size
    try:
        return pow(domain_of_size(n).group_gen, n, P.R_MODULUS) == 1
    except (ValueError, AssertionError):
        return False

for n in (1 << 11, 3 * (1 << 11), 27 * (1 << 4)):
    if not has_domain(n):
        continue
    x = elements(fr, 2 * n).reshape(2, n, fr.L)
    for inverse in (False, True):
        assert same(ntt.transform(x, inverse), ntt.transform(x, inverse, plain=True)), ("ntt", n, inverse)
print("ntt ok", flush=True)

ks = [int.from_bytes(rng.bytes(40), "little") % P.R_MODULUS for _ in range(64)]
pts = hc.g1_fixed_base_powers(hc.G1_GEN, [k or 1 for k in ks])
a, b = list(pts), pts[1:] + pts[:1]
a[0], b[1], b[2], a[3], b[3] = None, None, a[2], a[4], hc.g1_neg(a[4])
A, B = cd.from_affine_ints(a, dev), cd.from_affine_ints(b, dev)
S = curve.add_kernel(A, B)
assert same(S, curve.add_plain(A, B))
assert cd.to_affine_ints(S) == [hc.g1_add(x, y) for x, y in zip(a, b)]
assert same(curve.add_kernel(S, B), curve.add_plain(S, B))
assert same(curve.double_kernel(S), curve.double_plain(S))
scal = torch.as_tensor(ints_to_limbs([0, 1, P.R_MODULUS - 1] + ks[3:], 16).astype(np.int32), device=dev)
got = curve.scalar_mul_kernel(S, scal, P.FR_BITS)
assert same(got, curve.scalar_mul_plain(S, scal, P.FR_BITS))
c = msm._fixed_c(64)
table = msm.build_fixed_table(cd.from_affine_ints(pts, dev), c)
lay = torch.zeros((4, 64), dtype=torch.int32, device=dev)
lay[:, :40] = torch.arange(1, 41, device=dev, dtype=torch.int32)
lay[1, 3] = -9
lay[2, 5] = lay[2, 5 + 32] = -17
for exact in (False, True):
    kp, kf = curve.bucket_fold_kernel(table.xy, lay, exact)
    pp, pf = curve.bucket_fold_plain(table.xy, lay, exact)
    assert same(kp, pp) and int(kf) == int(pf), ("fold", exact)
W = 26
stacked = tuple(t[:W, None].contiguous() for t in S)
assert same(curve.combine_windows_kernel(stacked, 10), curve.combine_windows_plain(stacked, 10))
torch.cuda.synchronize()
print("curve kernels ok", flush=True)
"""


@pytest.mark.parametrize("curve", ["bn254", "bls12_377", "synthetic_lowadic"])
def test_other_curves_kernels_match_plain(dev, curve):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prog = f"CURVE = {curve!r}\n" + _CURVE_PROG
    env = dict(os.environ, MARLIN_TPU_CURVE=curve)
    res = subprocess.run([sys.executable, "-c", prog], cwd=root, env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "curve kernels ok" in res.stdout


# --------------------------------------------------------------------------
# test_wide750, a field with no curve, in a process of its own: kernels 1,
# 2 and 3 at 24 words against their plain versions, and its library's
# refusals (no group entry, no Fq)

_WIDE_PROG = r"""
import json
import numpy as np, torch
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import cuda, fr, ntt

assert P.CURVE_NAME == "test_wide750" and fr.L == 48
lib = cuda.lib()
dev = torch.device("cuda")
rng = np.random.default_rng(750)
res = {}

def elements(n):
    vals = [int.from_bytes(rng.bytes(100), "little") % P.R_MODULUS for _ in range(n)]
    vals[:4] = [0, 1, P.R_MODULUS - 2, P.R_MODULUS - 1][:n]
    return fr.from_ints(vals, dev)

a, b = elements(3000), elements(3000).flip(0)
raw = torch.as_tensor(rng.integers(0, 1 << 16, size=(3000, fr.L)).astype(np.int32), device=dev)
res["binop"] = all(torch.equal(bi.binop_kernel(k, fr.CTX, a, b), p(fr.CTX, a, b))
                   for k, p in (("mul", bi.mont_mul), ("add", bi.add_mod), ("sub", bi.sub_mod)))
res["binop"] = res["binop"] and torch.equal(bi.binop_kernel("mul", fr.CTX, raw, b), bi.mont_mul(fr.CTX, raw, b))
ok = True
for n in (1, 2, 7, 256, 4099):
    x = elements(n)
    for i in (0, 127, 128, 255, n - 1):
        if i < n and n > 1:
            x[i] = 0
    got = bi.inv_kernel(fr.CTX, x)
    ok = ok and torch.equal(got, bi.inv_mod(fr.CTX, x))
res["inv"] = bool(ok)
ok = True
for n in (1 << 11, 1 << 13, 9 << 11, 81 << 9):
    x = elements(n)
    for inverse in (False, True):
        ok = ok and torch.equal(ntt.transform(x, inverse), ntt.transform(x, inverse, plain=True))
res["transforms"] = bool(ok)
ok = True
for n in (27 << 11, 1 << 13):
    x = elements(n)
    if n & (n - 1):
        _, n2, tw, _, _, scale = ntt._mixed_tensors(n, True, dev)
    else:
        tw, scale = ntt._plan_tensors(n, True, dev)
        n2 = n
    log_n = n2.bit_length() - 1
    for log_b in (1, 9, 10):
        ok = ok and torch.equal(ntt.block_stages_kernel(x, tw, log_b, log_n, scale),
                                ntt.block_stages_plain(x, tw, log_b, log_n, scale))
    y = ntt.block_stages_plain(x, tw, 10, log_n, scale)
    ok = ok and torch.equal(ntt.cross_stages_kernel(y.clone(), tw, 10, log_n), ntt.cross_stages_plain(y, tw, 10, log_n))
# 3(b) at 24 words (2-adicity 13): 2^13 in one group of 6 stages past a
# 2^7 block (the widest group), and split over two past a 2^3 block
x = elements(1 << 13)
tw, _ = ntt._plan_tensors(1 << 13, False, dev)
assert ntt.cross_groups(13, 7) == [(7, 13)]
ok = ok and torch.equal(ntt.cross_stages_kernel(x.clone(), tw, 7, 13), ntt.cross_stages_plain(x, tw, 7, 13))
tw, _ = ntt._plan_tensors(1 << 13, True, dev)
for s0, s1 in ntt.cross_groups(13, 3):
    ok = ok and torch.equal(ntt.cross_stages_kernel(x.clone(), tw, s0, s1), ntt.cross_stages_plain(x, tw, s0, s1))
res["ntt_stages"] = bool(ok and len(ntt.cross_groups(13, 3)) == 2)
# kernel 1 at 24 words on broadcast operands, both bodies, no copy
ok = True
for sa, sb in (((3000,), (1,)), ((40, 1), (40, 75)), ((3, 1000), (1, 1000))):
    x, y = elements(int(np.prod(sa))).reshape(*sa, fr.L), elements(int(np.prod(sb))).reshape(*sb, fr.L)
    for staged in (False, True):
        cuda.reset_launches()
        ok = ok and all(torch.equal(bi.binop_kernel(k, fr.CTX, x, y, staged=staged), p(fr.CTX, x, y))
                        for k, p in (("mul", bi.mont_mul), ("add", bi.add_mod), ("sub", bi.sub_mod)))
        ok = ok and cuda.BINOP_COPIES["broadcast"] == 0
res["binop_broadcast"] = bool(ok)
fq_ctx = bi.ModCtx("fq", fr.CTX.modulus, fr.L, "test_wide750")
refused = 0
for call in (lambda: bi.binop_kernel("mul", fq_ctx, a, b), lambda: bi.inv_kernel(fq_ctx, a)):
    try:
        call()
    except RuntimeError:
        refused += 1
res["refusals"] = refused == 2 and not any(hasattr(lib, n) for n in ("marlin_g1_add", "marlin_bucket_fold"))
torch.cuda.synchronize()
print("RESULT " + json.dumps(res), flush=True)
"""


@functools.lru_cache(maxsize=None)
def _wide_results() -> dict:
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MARLIN_TPU_CURVE="test_wide750")
    res = subprocess.run([sys.executable, "-c", _WIDE_PROG], cwd=root, env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("check", ["binop", "inv", "transforms", "ntt_stages", "refusals", "binop_broadcast"])
def test_wide750_kernels_match_plain(dev, check):
    assert _wide_results()[check] is True
