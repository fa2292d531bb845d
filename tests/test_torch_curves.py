"""The port's other curves (BN254, BLS12-377, synthetic_lowadic) on the CPU.

* each curve's traits in csrc/mont.cuh (N, R mod N, R^3 mod N, -N^-1 mod
  2^32, the bit and word counts, the curve's number) recomputed from the
  port's config modules, read from the header text: no `nvcc` needed;
* the header's even/odd Montgomery product (`fe_mul`), emulated word for
  word in Python integers with its carry flag, for every curve's Fr and Fq:
  each result canonical and equal to a·b·R^-1 mod N, and every carry the
  chains drop zero, for canonical operands and for one operand below R;
* per curve, in one subprocess (the curve is chosen once a process): the
  port's plain binop, inversion, add, double, bucket fold and ladder against
  the JAX package's functions on the same seeded numpy inputs, limb for
  limb, and the curve ops also as affine points against the host group law;
  for BN254 also the one-constraint proof of tests/test_bn254_e2e.py under
  `test_rng()`, byte for byte against the JAX package's, and again from the
  JAX package's SRS and keys carried over by `interop`.

Every comparison is exact equality: the arithmetic is exact and both
packages return canonical residues.
"""

import functools
import json
import os
import re
import subprocess
import sys
import zlib

import numpy as np
import pytest

from marlin_tpu_torch.fields import bls12_377, bls12_381, bn254, synthetic_lowadic
from marlin_tpu_torch.ops import cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MONT_CUH = os.path.join(ROOT, "marlin_tpu_torch", "csrc", "mont.cuh")
CONFIGS = {"bls12_381": bls12_381, "bn254": bn254, "bls12_377": bls12_377,
           "synthetic_lowadic": synthetic_lowadic}
OTHER_CURVES = ["bn254", "bls12_377", "synthetic_lowadic"]


# --------------------------------------------------------------------------
# the header's traits


def _curve_block(curve: str) -> str:
    text = open(MONT_CUH).read()
    start = re.search(rf"#(?:el)?if defined\(MARLIN_CURVE_{curve.upper()}\)", text).end()
    end = re.search(r"\n#(?:elif|else)", text[start:]).start()
    return text[start : start + end]


def _traits(curve: str, struct: str) -> dict:
    block = _curve_block(curve)
    body = block[block.index(f"struct {struct} {{") :]
    body = body[: body.index("};")]

    def limbs(fn):
        part = body[body.index(f"constexpr uint32_t {fn}(int j)") :]
        part = part[: part.index("}\n  }")]
        vals = re.findall(r"return (0x[0-9a-f]+)u;", part)
        return sum(int(v, 16) << (32 * i) for i, v in enumerate(vals)), len(vals)

    nl = int(re.search(r"NL = (\d+);", body).group(1))
    return {
        "NL": nl, "BITS": int(re.search(r"BITS = (\d+);", body).group(1)),
        "NP0": int(re.search(r"NP0 = (0x[0-9a-f]+)u;", body).group(1), 16),
        "n": limbs("n"), "one": limbs("one"), "r3": limbs("r3"),
    }


@pytest.mark.parametrize("curve", list(CONFIGS))
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_mont_header_traits_match_the_curve_config(curve, field):
    P = CONFIGS[curve]
    N, nbytes = (P.R_MODULUS, P.FR_BYTES) if field == "fr" else (P.Q_MODULUS, P.FQ_BYTES)
    t = _traits(curve, "FrTraits" if field == "fr" else "FqTraits")
    nl = nbytes // 4
    R = 1 << (32 * nl)
    assert t["NL"] == nl and t["BITS"] == N.bit_length()
    assert t["n"] == (N, nl) and t["one"] == (R % N, nl) and t["r3"] == (R**3 % N, nl)
    assert t["NP0"] == (-pow(N, -1, 1 << 32)) % (1 << 32)
    assert N >> (32 * nl - 1) == 0  # the spare top bit the header asserts


@pytest.mark.parametrize("curve", list(CONFIGS))
def test_mont_header_names_each_curve_and_its_number(curve):
    block = _curve_block(curve)
    assert f'#define MARLIN_CURVE_NAME "{curve}"' in block
    assert int(re.search(r"#define MARLIN_CURVE_ID (\d+)", block).group(1)) == cuda.CURVE_IDS[curve]
    assert CONFIGS[curve].CURVE_NAME == curve


# --------------------------------------------------------------------------
# the even/odd product of mont.cuh, emulated with its carry flag

M32 = (1 << 32) - 1


class _Chain:
    """PTX's carry flag and the instructions of mont.cuh that use it; a
    dropped carry (one that no instruction consumes) is recorded."""

    def __init__(self):
        self.cf = 0
        self.dropped = 0

    def add(self, a, b, cin, cout):
        s = a + b + (self.cf if cin else 0)
        if cout:
            self.cf = s >> 32
        else:
            self.dropped |= s >> 32
        return s & M32

    def mad(self, lo, hi, a, b, cin, cout_hi=True):
        """(lo, hi) += a b (+ carry in), the mad.lo / madc.hi pair."""
        p = a * b
        lo = self.add(lo, p & M32, cin, True)
        hi = self.add(hi, p >> 32, True, cout_hi)
        return lo, hi


def _fe_mul(a, b, N, nl):
    """mont.cuh fe_mul on word lists -> (result words, dropped carries)."""
    ch = _Chain()
    n = [(N >> (32 * j)) & M32 for j in range(nl)]
    np0 = (-pow(N, -1, 1 << 32)) % (1 << 32)

    def mul_n(acc, x, bi):
        for j in range(0, nl, 2):
            p = x[j] * bi
            acc[j], acc[j + 1] = p & M32, p >> 32

    def cmad_n(acc, x, bi):
        for j in range(0, nl, 2):
            acc[j], acc[j + 1] = ch.mad(acc[j], acc[j + 1], x[j], bi, cin=j > 0)

    def madc_n_rshift(acc, x, bi, top):
        for j in range(0, nl - 2, 2):
            acc[j], acc[j + 1] = ch.mad(acc[j + 2], acc[j + 3], x[j], bi, cin=True)
        acc[nl - 2], acc[nl - 1] = ch.mad(0, top, x[nl - 2], bi, cin=True, cout_hi=False)

    def redc(even, odd, bi, top, first):
        a_odd, a_even = a[1:] + [0], a
        if first:
            mul_n(odd, a_odd, bi)
            mul_n(even, a_even, bi)
        else:
            even[0] = ch.add(even[0], odd[1], False, True)
            madc_n_rshift(odd, a_odd, bi, top)
            cmad_n(even, a_even, bi)
            odd[nl - 1] = ch.add(odd[nl - 1], 0, True, False)
        m = (even[0] * np0) & M32
        cmad_n(odd, n[1:] + [0], m)
        top = ch.add(0, 0, True, False)
        cmad_n(even, n, m)
        odd[nl - 1] = ch.add(odd[nl - 1], 0, True, True)
        return ch.add(top, 0, True, False)

    even, odd, top = [0] * nl, [0] * nl, 0
    for i in range(0, nl, 2):
        top = redc(even, odd, b[i], top, i == 0)
        top = redc(odd, even, b[i + 1], top, False)
    even[0] = ch.add(even[0], odd[1], False, True)
    for k in range(1, nl - 1):
        even[k] = ch.add(even[k], odd[k + 1], True, True)
    even[nl - 1] = ch.add(even[nl - 1], 0, True, False)
    t = sum(v << (32 * j) for j, v in enumerate(even))
    return (t - N if t >= N else t), ch.dropped


@pytest.mark.parametrize("curve", list(CONFIGS))
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_even_odd_product_is_exact_for_the_curve(curve, field):
    P = CONFIGS[curve]
    N, nbytes = (P.R_MODULUS, P.FR_BYTES) if field == "fr" else (P.Q_MODULUS, P.FQ_BYTES)
    nl = nbytes // 4
    R = 1 << (32 * nl)
    rng = np.random.default_rng(zlib.crc32(f"{curve}/{field}".encode()))
    edge = [0, 1, 2, N - 1, N - 2, R % N, (R * R) % N]
    vals = edge + [int.from_bytes(rng.bytes(nbytes + 8), "little") % N for _ in range(150)]
    below_r = [R - 1, N, N + 1] + [int.from_bytes(rng.bytes(nbytes), "little") for _ in range(40)]
    pairs = [(x, y) for x in edge for y in edge] + list(zip(vals, reversed(vals)))
    pairs += [(x, y) for x, y in zip(below_r, vals)]  # to_mont of raw limbs: a < R, b < N
    words = lambda x: [(x >> (32 * j)) & M32 for j in range(nl)]  # noqa: E731
    rinv = pow(R, -1, N)
    for x, y in pairs:
        got, dropped = _fe_mul(words(x), words(y), N, nl)
        assert dropped == 0, (x, y)
        assert got == x * y * rinv % N, (x, y)


# --------------------------------------------------------------------------
# the plain versions against the JAX package, one subprocess per curve

_PROG = r"""
import hashlib, json, os, sys
import numpy as np
import torch
import jax.numpy as jnp
from marlin_tpu.ops import curve_device as jcd, fq as jfq, fr as jfr
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.fields import host_curve as hc
from marlin_tpu_torch.ops import curve, fq, fr, msm
from marlin_tpu_torch.ops import curve_device as cd
from marlin_tpu_torch.ops.limbs import ints_to_limbs

assert P.CURVE_NAME == sys.argv[1]
res = {}
rng = np.random.default_rng(11)


def values(N, n):
    nbytes = (N.bit_length() + 7) // 8 + 8
    return [0, 1, N - 2, N - 1, 2] + [int.from_bytes(rng.bytes(nbytes), "little") % N for _ in range(n)]


def J(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def J3(p):
    return tuple(J(c) for c in p)


def same(t, j):
    return np.array_equal(t.numpy().astype(np.int64), np.asarray(j).astype(np.int64))


def same3(p, jp):
    return all(same(a, b) for a, b in zip(p, jp))


def affine(jp):
    return cd.affine_ints_from_raw(*(np.asarray(c).astype(np.int64) for c in jp))


for name, mod, jmod in (("fr", fr, jfr), ("fq", fq, jfq)):
    N = mod.CTX.modulus
    xs, ys = values(N, 60), values(N, 60)[::-1]
    a, b = mod.from_ints(xs, "cpu"), mod.from_ints(ys, "cpu")
    hosts = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y, "sub": lambda x, y: x - y}
    for op, host in hosts.items():
        got = getattr(mod, op)(a, b)
        res[f"{name}_{op}"] = bool(same(got, getattr(jmod, op)(J(a), J(b)))
                                   and mod.to_ints(got) == [host(x, y) % N for x, y in zip(xs, ys)])
    zs = values(N, 30) + [0]
    z = mod.from_ints(zs, "cpu")
    got = mod.inv(z)
    res[f"{name}_inv"] = bool(same(got, jmod.inv(J(z)))
                              and mod.to_ints(got) == [pow(x, -1, N) if x else 0 for x in zs])

r, q = P.R_MODULUS, P.Q_MODULUS
ks = [int.from_bytes(rng.bytes(40), "little") % (r - 1) + 1 for _ in range(48)]
pts = hc.g1_fixed_base_powers(hc.G1_GEN, ks)
a, b = list(pts[:24]), pts[24:]
a[0], b[1], b[2], a[3], b[3] = None, None, a[2], a[4], hc.g1_neg(a[4])
A, B = cd.from_affine_ints(a, "cpu"), cd.from_affine_ints(b, "cpu")
S = curve.add_plain(A, B)
jS = jcd._add_xla(J3(A), J3(B))
want = [hc.g1_add(x, y) for x, y in zip(a, b)]
res["g1_add"] = bool(same3(S, jS) and cd.to_affine_ints_host(S) == affine(jS) == want)
S2 = curve.add_plain(S, B)  # Jacobian operands (Z != 1)
jS2 = jcd._add_xla(jS, J3(B))
res["g1_add_jacobian"] = bool(same3(S2, jS2) and cd.to_affine_ints_host(S2) == affine(jS2)
                              == [hc.g1_add(x, y) for x, y in zip(want, b)])
D = curve.double_plain(S)
jD = jcd._double_xla(jS)
res["g1_double"] = bool(same3(D, jD) and cd.to_affine_ints_host(D) == affine(jD)
                        == [hc.g1_add(x, x) for x in want])

# the fold: 5 lanes of 12 signed slots; lane 2 empty; lane 4 meets P == Q
rows = pts[:40]
table = curve.pack_points_xy(*cd.from_affine_ints(rows, "cpu")[:2])
lay = np.zeros((5, 12), np.int32)
for lane in range(5):
    fill = int(rng.integers(4, 13))
    lay[lane, :fill] = (rng.permutation(40)[:fill] + 1) * rng.choice([-1, 1], size=fill)
lay[2] = 0
lay[4] = 0
lay[4, 1] = lay[4, 9] = -7
for exact in (False, True):
    got, flags = curve.bucket_fold_plain(table, torch.as_tensor(lay), exact, subrows=8)
    sums = []
    for lane in range(5):
        acc = jcd.identity((1,))
        for e in lay[lane]:
            if e:
                p = rows[abs(e) - 1] if e > 0 else hc.g1_neg(rows[abs(e) - 1])
                acc = jcd._add_xla(acc, J3(cd.from_affine_ints([p], "cpu")))
        sums.append(affine(acc)[0])
    affs = cd.to_affine_ints_host(got)
    ok = int(flags) == (0 if exact else 1) and affs[2] is None
    ok = ok and all(affs[i] == sums[i] for i in range(5) if exact or i != 4)
    res[f"bucket_fold_{'exact' if exact else 'fast'}"] = bool(ok)

# the ladder: identities, a point off affine form, scalars 0, 1, r - 1
lp = list(pts[:8])
lp[4] = lp[6] = None
sk = [0, 1, r - 1, 5] + ks[:4]
sk[6] = r - 1
L = cd.from_affine_ints(lp, "cpu")
zz = 0x7654321
x, y = lp[5]
for t, v in zip(L, fq.from_ints([x * zz * zz % q, y * zz**3 % q, zz], "cpu")):
    t[5] = v
scal = torch.as_tensor(ints_to_limbs(sk, fr.L).astype(np.int32))
got = curve.scalar_mul_plain(L, scal, P.FR_BITS)
jgot = jcd.scalar_mul_batch(J3(L), J(scal), P.FR_BITS)
res["g1_scalar_mul"] = bool(same3(got, jgot) and cd.to_affine_ints_host(got) == affine(jgot)
                            == [hc.g1_mul(p, k) if p else None for p, k in zip(lp, sk)])
fb = msm.fixed_base_powers(hc.G1_GEN, [0, 1, 2, r - 1, 12345], "cpu")
res["fixed_base_powers"] = bool(cd.to_affine_ints(fb) == hc.g1_fixed_base_powers(hc.G1_GEN, [0, 1, 2, r - 1, 12345]))

if os.environ.get("PROVE") == "1":
    import marlin_tpu.snark.marlin as jm
    import marlin_tpu.utils.rand as jr
    import marlin_tpu.snark.r1cs as jr1
    import marlin_tpu_torch.snark.marlin as tm
    import marlin_tpu_torch.utils.rand as tr
    import marlin_tpu_torch.snark.r1cs as tr1
    from marlin_tpu_torch import interop

    def circuit(lc):
        class C:
            def generate_constraints(self, cs):
                x = cs.new_witness_variable(lambda: 3)
                y = cs.new_witness_variable(lambda: 5)
                out = cs.new_input_variable(lambda: 15)
                cs.enforce_constraint(lc(x), lc(y), lc(out))
        return C()

    rng_j = jr.test_rng()
    srs_j = jm.Marlin.universal_setup(32, 32, 96, rng_j)
    plain_srs = interop.to_plain(srs_j)
    pk_j, vk_j = jm.Marlin.index(srs_j, circuit(jr1.lc))
    plain_pk = interop.to_plain(pk_j)
    proof_j = jm.Marlin.prove(pk_j, circuit(jr1.lc), rng_j).to_bytes()
    rng_t = tr.test_rng()
    srs_t = tm.Marlin.universal_setup(32, 32, 96, rng_t, device="cpu")
    pk_t, vk_t = tm.Marlin.index(srs_t, circuit(tr1.lc), device="cpu")
    proof_t = tm.Marlin.prove(pk_t, circuit(tr1.lc), rng_t, device="cpu")
    res["proof_bytes_equal"] = proof_t.to_bytes() == proof_j
    res["proof_size"] = len(proof_j) == 647 == proof_t.serialized_size()
    res["proof_verifies"] = bool(tm.Marlin.verify(vk_t, [15], proof_t, rng_t, device="cpu")
                                 and not tm.Marlin.verify(vk_t, [16], proof_t, rng_t, device="cpu"))
    # the JAX package's SRS and index keys, carried over: the same bytes
    srs_i = interop.universal_params(plain_srs, "cpu")
    pk_i, _ = interop.index_keys(plain_pk, "cpu")
    rng_i = tr.test_rng()
    tm.Marlin.universal_setup(32, 32, 96, rng_i, device="cpu")  # the same rng state as the prove's
    res["interop_proof_bytes_equal"] = (
        tm.Marlin.prove(pk_i, circuit(tr1.lc), rng_i, device="cpu").to_bytes() == proof_j
        and srs_i.powers_of_g[0].shape[-1] == fq.L)
print("RESULT " + json.dumps(res), flush=True)
"""

CHECKS = ["fr_mul", "fr_add", "fr_sub", "fr_inv", "fq_mul", "fq_add", "fq_sub", "fq_inv",
          "g1_add", "g1_add_jacobian", "g1_double", "bucket_fold_fast", "bucket_fold_exact",
          "g1_scalar_mul", "fixed_base_powers"]
PROOF_CHECKS = ["proof_bytes_equal", "proof_size", "proof_verifies", "interop_proof_bytes_equal"]


@functools.lru_cache(maxsize=None)
def _results(curve: str) -> dict:
    env = dict(os.environ, MARLIN_TPU_CURVE=curve, JAX_PLATFORMS="cpu", MARLIN_TPU_XLA_CACHE="",
               TF_CPP_MIN_LOG_LEVEL="3", MARLIN_TPU_HOST_MSM="1", MARLIN_TPU_FUSE_ROUNDS="0",
               PROVE="1" if curve == "bn254" else "0",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _PROG, curve], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("curve", OTHER_CURVES)
def test_plain_versions_equal_the_jax_package(curve, check):
    assert _results(curve)[check] is True


@pytest.mark.parametrize("check", PROOF_CHECKS)
def test_bn254_proof_equals_the_jax_package(check):
    assert _results("bn254")[check] is True
