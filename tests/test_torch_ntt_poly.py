"""The port's radix-2 NTT and polynomial ops against the JAX package.

Sizes are 2^11 and below.  On the CPU the NTT runs the plain twins of its
two stage kernels: the in-block stages (`block_stages_plain`) and one call
per group of wider stages (`cross_stages_plain`); the in-block size is a parameter,
so both twins run at several splits.  The JAX package computes its side in
one subprocess (its XLA route), so this process compiles nothing with XLA.
Exact equality throughout: field arithmetic is exact and both packages
return canonical limbs.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from marlin_tpu_torch.ops import fr, ntt, poly

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 11
R = fr.CTX.modulus
Z_EVAL = 0x1234567890ABCDEF % R
Z_LINEAR = 987654321987654321 % R
VANISHING_CASES = [(N, 256), (1000, 4), (200, 256)]

_JAX_SIDE = r"""
import pickle, sys
import jax.numpy as jnp
import numpy as np
from marlin_tpu.ops import fr, ntt, poly

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
n = inp["n"]
A = lambda v: np.asarray(v)
out = {}
x = fr.from_ints(inp["vec"])
out["ntt"] = A(ntt.ntt(x, n))
out["intt"] = A(ntt.intt(x))
out["ntt_short"] = A(ntt.ntt(x[:1500], n))
out["ntt_many"] = [A(v) for v in ntt.ntt_many([fr.from_ints(p) for p in inp["many"]], n)]
out["intt_many"] = [A(v) for v in ntt.intt_many([fr.from_ints(p) for p in inp["many_evals"]])]
out["domain"] = A(ntt.domain_elements(n))
out["mul"] = A(poly.mul(fr.from_ints(inp["mul"][0]), fr.from_ints(inp["mul"][1])))
out["vanishing"] = [
    tuple(A(v) for v in poly.divide_by_vanishing(fr.from_ints(p), d)) for p, d in inp["vanishing"]
]
stack = jnp.stack([fr.from_ints(p) for p in inp["eval"]])
out["eval"] = A(poly.evaluate_batch(stack, fr.from_int(inp["z_eval"])))
out["linear"] = A(poly.div_by_linear(fr.from_ints(inp["linear"]), fr.from_int(inp["z_linear"])))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ints(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]
    edges = [0, 1, R - 1][:n]
    vals[: len(edges)] = edges
    return vals


def _inputs() -> dict:
    return {
        "n": N,
        "vec": _ints(N, 1),
        "many": [_ints(N - 5 * i, 10 + i) for i in range(3)],
        "many_evals": [_ints(N, 20 + i) for i in range(2)],
        "mul": (_ints(700, 30), _ints(333, 31)),
        "vanishing": [(_ints(length, 40), d) for length, d in VANISHING_CASES],
        "eval": [_ints(300, 50 + i) for i in range(3)],
        "z_eval": Z_EVAL,
        "linear": _ints(513, 60),
        "z_linear": Z_LINEAR,
    }


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_ntt_poly")
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


def _t(vals: list) -> torch.Tensor:
    return fr.from_ints(vals, "cpu")


@pytest.mark.parametrize("block_log2", [3, 10, 11])
@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
def test_transform_matches_jax(case, block_log2, inverse):
    inp, ref = case
    got = ntt.transform(_t(inp["vec"]), inverse, block_log2=block_log2)
    assert _same(got, ref["intt" if inverse else "ntt"])


def test_ntt_pads_and_round_trips(case):
    inp, ref = case
    short = _t(inp["vec"])[:1500]
    assert _same(ntt.ntt(short, N), ref["ntt_short"])
    assert np.array_equal(ntt.intt(ntt.ntt(short, N))[:1500].numpy(), short.numpy())


def test_batched_transforms_match_jax(case):
    inp, ref = case
    for got, want in zip(ntt.ntt_many([_t(p) for p in inp["many"]], N), ref["ntt_many"]):
        assert _same(got, want)
    for got, want in zip(ntt.intt_many([_t(p) for p in inp["many_evals"]]), ref["intt_many"]):
        assert _same(got, want)


def test_domain_elements_match_jax(case):
    _inp, ref = case
    assert _same(ntt.domain_elements(N, "cpu"), ref["domain"])


def test_poly_mul_matches_jax(case):
    inp, ref = case
    a, b = inp["mul"]
    assert _same(poly.mul(_t(a), _t(b)), ref["mul"])


@pytest.mark.parametrize("which", range(len(VANISHING_CASES)))
def test_divide_by_vanishing_matches_jax(case, which):
    inp, ref = case
    p, domain = inp["vanishing"][which]
    q, r = poly.divide_by_vanishing(_t(p), domain)
    jq, jr = ref["vanishing"][which]
    assert _same(q, jq) and _same(r, jr)
    # p == q * (x^n - 1) + r
    back = poly.add(poly.mul_by_vanishing(q, domain), r)[: len(p)]
    assert np.array_equal(back.numpy(), _t(p).numpy())


def test_evaluate_batch_matches_jax_and_host(case):
    inp, ref = case
    polys = inp["eval"]
    got = poly.evaluate_batch(torch.stack([_t(p) for p in polys]), fr.from_int(Z_EVAL, "cpu"))
    assert _same(got, ref["eval"])
    assert fr.to_ints(got) == [sum(c * pow(Z_EVAL, i, R) for i, c in enumerate(p)) % R for p in polys]


def test_div_by_linear_matches_jax(case):
    inp, ref = case
    p, z = _t(inp["linear"]), fr.from_int(Z_LINEAR, "cpu")
    got = poly.div_by_linear(p, z)
    assert _same(got, ref["linear"])
    shared = poly.div_by_linear(p, z, fr.inv(z[None]))
    assert np.array_equal(shared.numpy(), got.numpy())
