"""The port's field arithmetic (marlin_tpu_torch.ops.{bigint,fr,fq,mont})
against the JAX package and host ints.

Inputs come from a numpy seed and include the edges 0, 1, N-2 and N-1.  On
the CPU the port runs its plain versions (the same functions its CUDA
kernels are held against on the card).  The JAX package computes its side
in one subprocess (the XLA route its own CPU tests use, and its Pallas
kernel in interpret mode), so this process compiles nothing with XLA.
Every comparison is exact equality: field arithmetic is exact, and both
packages return canonical residues (< N), so equal values mean equal limbs.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import fq, fr, mont
from marlin_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {"fr": fr, "fq": fq}

_JAX_SIDE = r"""
import pickle, sys
import numpy as np
from marlin_tpu.ops import bigint as jbi, fq as jfq, fr as jfr
from marlin_tpu.ops.pallas import field as pfield

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
mods = {"fr": jfr, "fq": jfq}
out = {}
for field, (xs, ys) in inp["binop"].items():
    m = mods[field]
    a, b = m.from_ints(xs), m.from_ints(ys)
    for op in ("mul", "add", "sub"):
        out[("binop", field, op)] = np.asarray(getattr(m, op)(a, b))
for field, xs in inp["inv"].items():
    out[("inv", field)] = np.asarray(mods[field].inv(mods[field].from_ints(xs)))
for field, canonical in inp["mont"].items():
    ctx = mods[field].CTX
    m = jbi.to_mont(ctx, canonical)
    out[("to_mont", field)] = np.asarray(m)
    out[("from_mont", field)] = np.asarray(jbi.from_mont(ctx, m))
for field, op, xs, ys in inp["pallas"]:
    m = mods[field]
    got = pfield.binop(op, m.CTX, m.from_ints(xs), m.from_ints(ys), interpret=True)
    out[("pallas", field, op)] = np.asarray(got)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _values(modulus: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    nbytes = (modulus.bit_length() + 7) // 8 + 8
    rand = [int.from_bytes(rng.bytes(nbytes), "little") % modulus for _ in range(n)]
    return [0, 1, modulus - 2, modulus - 1, 2] + rand


def _inputs() -> dict:
    inp = {"binop": {}, "inv": {}, "mont": {}, "pallas": []}
    for field, mod in FIELDS.items():
        N = mod.CTX.modulus
        inp["binop"][field] = (_values(N, 200, 1), list(reversed(_values(N, 200, 2))))
        inp["inv"][field] = _values(N, 27, 3) + [0]
        inp["mont"][field] = ints_to_limbs(_values(N, 100, 4), mod.CTX.L)
    # one tile of the TPU field kernel: Fr mul (the product mont_mul_pallas
    # computes) and Fq mul / sub
    fr_x, fr_y = _values(fr.CTX.modulus, 1019, 7), list(reversed(_values(fr.CTX.modulus, 1019, 8)))
    fq_x, fq_y = _values(fq.CTX.modulus, 1019, 9), list(reversed(_values(fq.CTX.modulus, 1019, 10)))
    inp["pallas"] = [("fr", "mul", fr_x, fr_y), ("fq", "mul", fq_x, fq_y), ("fq", "sub", fq_x, fq_y)]
    return inp


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_field")
    inp = _inputs()
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", MARLIN_TPU_XLA_CACHE="", TF_CPP_MIN_LOG_LEVEL="3",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp / "in.pkl"), str(tmp / "out.pkl")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return inp, pickle.load(f)


def _same(t: torch.Tensor, ref) -> bool:
    return np.array_equal(t.numpy(), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binop_matches_jax_and_host(case, field, op):
    inp, ref = case
    mod = FIELDS[field]
    N = mod.CTX.modulus
    xs, ys = inp["binop"][field]
    got = getattr(mod, op)(mod.from_ints(xs, "cpu"), mod.from_ints(ys, "cpu"))
    assert _same(got, ref[("binop", field, op)])
    host = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y, "sub": lambda x, y: x - y}[op]
    assert mod.to_ints(got) == [host(x, y) % N for x, y in zip(xs, ys)]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_inv_matches_jax_and_host_zero_to_zero(case, field):
    inp, ref = case
    mod = FIELDS[field]
    N = mod.CTX.modulus
    xs = inp["inv"][field]
    got = mod.inv(mod.from_ints(xs, "cpu"))
    assert _same(got, ref[("inv", field)])
    assert mod.to_ints(got) == [pow(x, -1, N) if x else 0 for x in xs]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_to_and_from_montgomery_match_jax(case, field):
    inp, ref = case
    ctx = FIELDS[field].CTX
    canonical = inp["mont"][field]
    xs = limbs_to_ints(canonical)
    mont_t = bi.to_mont(ctx, torch.as_tensor(canonical.astype(np.int32)))
    assert _same(mont_t, ref[("to_mont", field)])
    assert FIELDS[field].to_ints(mont_t) == xs
    back = bi.from_mont(ctx, mont_t)
    assert _same(back, ref[("from_mont", field)])
    assert limbs_to_ints(back.numpy()) == xs


def test_binops_match_pallas_interpret_tile(case):
    """One tile of the TPU field kernel (pallas/field.py::binop), run in
    interpret mode, against the port: ops/mont.py::mont_mul (the entry
    standing for pallas/mont.py::mont_mul_pallas, the same Fr product) and
    Fq mul / sub."""
    inp, ref = case
    for field, op, xs, ys in inp["pallas"]:
        mod = FIELDS[field]
        a, b = mod.from_ints(xs, "cpu"), mod.from_ints(ys, "cpu")
        got = mont.mont_mul(a, b) if field == "fr" else getattr(mod, op)(a, b)
        assert _same(got, ref[("pallas", field, op)]), (field, op)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_neg_and_pow_const_match_host(field):
    mod = FIELDS[field]
    ctx = mod.CTX
    N = ctx.modulus
    xs = _values(N, 40, 11)
    x = mod.from_ints(xs, "cpu")
    assert mod.to_ints(bi.neg_mod(ctx, x)) == [(-v) % N for v in xs]
    e = 0xD201000000010001
    bits = [int(c) for c in bin(e)[2:]]
    assert mod.to_ints(bi.pow_const(ctx, x, bits)) == [pow(v, e, N) for v in xs]


def test_reduce_wide_and_modsum_match_host():
    rng = np.random.default_rng(5)
    wide = torch.as_tensor(rng.integers(0, 1 << 40, size=(64, 20)), dtype=torch.int64)
    vals = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in wide.tolist()]
    got = bi.reduce_wide(fr.CTX, wide)
    assert limbs_to_ints(got.numpy()) == [v % fr.CTX.modulus for v in vals]
    xs = _values(fr.CTX.modulus, 300, 6)
    s = fr.modsum(fr.from_ints(xs, "cpu"))
    assert fr.to_int(s) == sum(xs) % fr.CTX.modulus
