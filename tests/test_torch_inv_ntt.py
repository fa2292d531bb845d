"""The port's plain batch inversion and fused plain NTT against the JAX
package and host ints.

The batch inversion (`bigint.inv_mod`: zeros as one, a product tree up and
down, one root) is held against the TPU kernel, `pallas/field.py::inv` in
interpret mode, for Fr and Fq at n = 1, 2, 7, 256 and 4099, with zeros at
the first and last position of a kernel chunk (a thread's run, a
128-element block, the batch) and an all-zero batch.  The fused plain
transform (`ntt.transform(plain=True)`: bit-reversal gather and n^-1 in the
in-block stage twin) runs batched [2, 2^log_n], forward and inverse, at
every in-block size the CUDA kernel takes (1..min(log_n, 10)), for log_n =
1..12: against a host-int radix-2 FFT at every size, and against the JAX
package's `ntt_many` / `intt_many` at 2^1, 2^5, 2^10 and 2^12 (each JAX
size is one XLA compile; the set spans transforms inside one 2^10 block,
of one block exactly, and wider).  The JAX side runs in three subprocesses
side by side (Fr inversion, Fq inversion, NTT), so this process compiles
nothing with XLA.  Exact equality throughout: both packages return
canonical residues.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import fq, fr, ntt
from marlin_tpu_torch.snark.domains import Radix2Domain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {"fr": fr, "fq": fq}
R = fr.CTX.modulus
INV_SIZES = [1, 2, 7, 256, 4099]
ZERO_AT = (0, 127, 128, 255, 4096)  # and n - 1
NTT_LOG2 = range(1, 13)
JAX_NTT_LOG2 = (1, 5, 10, 12)
BATCH = 2

_JAX_INV = r"""
import pickle, sys
import numpy as np
from marlin_tpu.ops import fq, fr
from marlin_tpu.ops.pallas import field as pfield

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
mods = {"fr": fr, "fq": fq}
out = {}
for field, xs in inp.items():  # every case of a field in one call
    m = mods[field]
    out[field] = np.asarray(pfield.inv(m.CTX, m.from_ints(xs), interpret=True))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""

_JAX_NTT = r"""
import pickle, sys
import numpy as np
from marlin_tpu.ops import fr, ntt

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
out = {}
for log_n, rows in inp.items():
    polys = [fr.from_ints(r) for r in rows]
    out[(log_n, False)] = np.stack([np.asarray(v) for v in ntt.ntt_many(polys, 1 << log_n)])
    out[(log_n, True)] = np.stack([np.asarray(v) for v in ntt.intt_many(polys)])
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _ints(modulus: int, n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    nbytes = (modulus.bit_length() + 7) // 8 + 8
    return [int.from_bytes(rng.bytes(nbytes), "little") % modulus for _ in range(n)]


def _inv_cases(field: str) -> list:
    """[(name, values)]: each size with zeros at the chunk edges, and five zeros."""
    N = FIELDS[field].CTX.modulus
    cases = []
    for n in INV_SIZES:
        xs = _ints(N, n, n)
        for i in ZERO_AT + (n - 1,):
            if i < n and n > 2:
                xs[i] = 0
        if n == 2:
            xs[1] = 0
        cases.append((f"n={n}", xs))
    cases.append(("all zero", [0] * 5))
    return cases


def _ntt_rows(log_n: int) -> list:
    rows = [_ints(R, 1 << log_n, 100 * log_n + b) for b in range(BATCH)]
    rows[0][: min(3, 1 << log_n)] = [0, 1, R - 1][: 1 << log_n]
    return rows


def _run(script: str, inp, tmp, name: str) -> subprocess.Popen:
    with open(tmp / f"{name}_in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", MARLIN_TPU_XLA_CACHE="", TF_CPP_MIN_LOG_LEVEL="3",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", script, str(tmp / f"{name}_in.pkl"), str(tmp / f"{name}_out.pkl")],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_inv_ntt")
    procs = {field: _run(_JAX_INV, {field: [v for _, xs in _inv_cases(field) for v in xs]}, tmp, field)
             for field in FIELDS}
    procs["ntt"] = _run(_JAX_NTT, {ln: _ntt_rows(ln) for ln in JAX_NTT_LOG2}, tmp, "ntt")
    out = {"inv": {}}
    for name, p in procs.items():
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-4000:]
        with open(tmp / f"{name}_out.pkl", "rb") as f:
            got = pickle.load(f)
        if name == "ntt":
            out["ntt"] = got
        else:
            out["inv"].update(got)
    return out


def _same(t: torch.Tensor, want) -> bool:
    return np.array_equal(t.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("case", [f"n={n}" for n in INV_SIZES] + ["all zero"])
def test_plain_batch_inversion_matches_jax_and_host(ref, field, case):
    mod = FIELDS[field]
    N = mod.CTX.modulus
    cases = _inv_cases(field)
    start = 0
    for name, xs in cases:
        if name == case:
            break
        start += len(xs)
    want = ref["inv"][field][start : start + len(xs)]
    got = bi.inv_mod(mod.CTX, mod.from_ints(xs, "cpu"))
    assert _same(got, want)
    assert mod.to_ints(got) == [pow(x, -1, N) if x else 0 for x in xs]


def _host_ntt(vals: list, inverse: bool) -> list:
    """Radix-2 evaluation on Radix2Domain(n) (or interpolation) in host ints."""
    n = len(vals)
    dom = Radix2Domain(n)
    g = dom.group_gen_inv if inverse else dom.group_gen

    def fft(a, w):
        if len(a) == 1:
            return a
        even, odd = fft(a[0::2], w * w % R), fft(a[1::2], w * w % R)
        out, t, h = [0] * len(a), 1, len(a) // 2
        for k in range(h):
            p = t * odd[k] % R
            out[k], out[k + h] = (even[k] + p) % R, (even[k] - p) % R
            t = t * w % R
        return out

    out = fft(vals, g)
    if inverse:
        n_inv = pow(n, -1, R)
        out = [v * n_inv % R for v in out]
    return out


@pytest.mark.parametrize("log_n", NTT_LOG2)
def test_fused_plain_transform_matches_jax_and_host(ref, log_n):
    """Every in-block size the kernel takes, forward and inverse, batched."""
    rows = _ntt_rows(log_n)
    x = torch.stack([fr.from_ints(r, "cpu") for r in rows])
    for inverse in (False, True):
        want = [_host_ntt(r, inverse) for r in rows]
        jax_out = ref["ntt"].get((log_n, inverse))
        for log_b in range(1, min(log_n, ntt.BLOCK_LOG2) + 1):
            got = ntt.transform(x, inverse, plain=True, block_log2=log_b)
            assert [fr.to_ints(g) for g in got] == want, (inverse, log_b)
            if jax_out is not None:
                assert _same(got, jax_out), (inverse, log_b)


def test_public_transforms_match_jax(ref):
    """ntt / intt / ntt_many / intt_many at 2^12 on the CPU route."""
    log_n = 12
    polys = [fr.from_ints(r, "cpu") for r in _ntt_rows(log_n)]
    fwd, inv = ref["ntt"][(log_n, False)], ref["ntt"][(log_n, True)]
    assert _same(torch.stack(ntt.ntt_many(polys, 1 << log_n)), fwd)
    assert _same(torch.stack(ntt.intt_many(polys)), inv)
    assert _same(ntt.ntt(polys[0], 1 << log_n), fwd[0])
    assert _same(ntt.intt(polys[1]), inv[1])
