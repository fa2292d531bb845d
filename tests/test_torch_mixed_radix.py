"""The port's mixed-radix NTT (ops/ntt.py) against the JAX package, on the CPU.

* synthetic_lowadic (2-adicity 13, a 3^3 subgroup), in one subprocess: the
  port's `transform` at 3·2^k, 9·2^k and 27·2^k points, forward and
  inverse, against the reference's `_ntt_mixed_jit` (marlin_tpu/ops/ntt.py:
  201) and a naive DFT over the domain's generator, also with the in-block
  stages cut to 2^2 so the inner transforms take cross stages; a batch of
  two; `ntt_many`/`intt_many` per polynomial against `ntt`/`intt`;
* BN254 under `MARLIN_TPU_FR_TWO_ADICITY_CAP=6`, in one subprocess: the
  80-constraint `DummyCircuit` of tests/test_mixed_radix.py on mixed
  domains (|H| = 96 = 3·2^5, |K| = 288 = 9·2^5, a mixed mul domain, so
  round 2 trims `h_1`'s zero tail), the port's proof byte for byte against
  the JAX package's under `test_rng()`, and verified.

Exact equality throughout: the transforms compute canonical residues.
"""

import functools
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NTT_PROG = r"""
import json
import numpy as np
import torch
import jax.numpy as jnp
from marlin_tpu.ops import ntt as jntt
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.ops import fr, ntt
from marlin_tpu_torch.snark.domains import MixedRadixDomain

assert P.CURVE_NAME == "synthetic_lowadic"
R = P.R_MODULUS
rng = np.random.default_rng(3)
res = {}
for n in (3 * 8, 9 * 16, 27 * 8, 3 * 2048):
    vals = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]
    vals[:3] = [0, 1, R - 1]
    x = fr.from_ints(vals, "cpu")
    dom = MixedRadixDomain(n)
    for inverse in (False, True):
        ntt.MIXED_TRANSFORMS["cpu"] = 0
        got = ntt.transform(x, inverse)
        mixed = ntt.MIXED_TRANSFORMS["cpu"] == 1
        jgot = np.asarray(jntt._ntt_mixed_jit(jnp.asarray(x.numpy().astype(np.uint32)), inverse))
        small_blocks = ntt.transform(x, inverse, block_log2=2)
        ok = mixed and np.array_equal(got.numpy().astype(np.int64), jgot.astype(np.int64))
        ok = ok and torch.equal(got, small_blocks)
        if n <= 216:  # the naive DFT, O(n^2) host products
            w = dom.group_gen_inv if inverse else dom.group_gen
            want = [sum(v * pow(w, j * k, R) for j, v in enumerate(vals)) % R for k in range(n)]
            if inverse:
                want = [v * pow(n, -1, R) % R for v in want]
            ok = ok and fr.to_ints(got) == want
        res[f"{n}_{'inverse' if inverse else 'forward'}"] = bool(ok)
    batch = torch.stack([x, x.flip(0)])
    res[f"{n}_batch"] = bool(torch.equal(ntt.transform(batch, False)[1], ntt.transform(x.flip(0), False))
                             and torch.equal(ntt.intt(ntt.ntt(x, n)), x))
polys = [fr.from_ints(list(range(1, 100 - 7 * i)), "cpu") for i in range(3)]
many = ntt.ntt_many(polys, 27 * 8)
res["ntt_many"] = all(torch.equal(m, ntt.ntt(p, 27 * 8)) for m, p in zip(many, polys))
res["intt_many"] = all(torch.equal(a, ntt.intt(m)) for a, m in zip(ntt.intt_many(many), many))
print("RESULT " + json.dumps(res), flush=True)
"""

_PROOF_PROG = r"""
import json, sys
sys.path.insert(0, "tests")
from circuits import DummyCircuit as JaxCircuit, R
import marlin_tpu.snark.marlin as jm
import marlin_tpu.utils.rand as jr
import marlin_tpu_torch.snark.marlin as tm
import marlin_tpu_torch.snark.prover as tp
import marlin_tpu_torch.utils.rand as tr
from marlin_tpu_torch.ops import ntt
from marlin_tpu_torch.snark.r1cs import lc


class DummyCircuit:
    def __init__(self, a, b, num_variables, num_constraints):
        self.a, self.b, self.nv, self.nc = a, b, num_variables, num_constraints

    def generate_constraints(self, cs):
        a = cs.new_witness_variable(lambda: self.a)
        b = cs.new_witness_variable(lambda: self.b)
        c = cs.new_input_variable(lambda: self.a * self.b % R)
        for _ in range(self.nv - 3):
            cs.new_witness_variable(lambda: self.a)
        for _ in range(self.nc - 1):
            cs.enforce_constraint(lc(a), lc(b), lc(c))
        cs.enforce_constraint(lc(), lc(), lc())


res = {}
rng = jr.test_rng()
a, b = rng.rand_fr(), rng.rand_fr()
srs = jm.Marlin.universal_setup(80, 80, 280, rng)
pk, vk = jm.Marlin.index(srs, JaxCircuit(a, b, num_constraints=80, num_variables=10))
want = jm.Marlin.prove(pk, JaxCircuit(a, b, num_constraints=80, num_variables=10), rng).to_bytes()

round2 = []  # (length of h_1 from the round-2 core, the trim's bound mul_size - h)
core = tp._round2_core


def watched_core(*args, h, **kwargs):
    t_poly, g_1, h_1 = core(*args, h=h, **kwargs)
    mask_len = args[2].shape[0]
    za_len = args[0].shape[0]
    x_size = kwargs["x_size"]
    mul_size = max(mask_len, h + 2 * za_len - 1, 2 * h + x_size + 2)
    round2.append((int(h_1.shape[0]), mul_size - h, kwargs["n_mul"]))
    return t_poly, g_1, h_1


tp._round2_core = watched_core
rng = tr.test_rng()
a2, b2 = rng.rand_fr(), rng.rand_fr()
circ = DummyCircuit(a2, b2, num_variables=10, num_constraints=80)
srs = tm.Marlin.universal_setup(80, 80, 280, rng, device="cpu")
pk, vk = tm.Marlin.index(srs, circ, device="cpu")
h, k = pk.index.domain_h.size, pk.index.domain_k.size
ntt.MIXED_TRANSFORMS["cpu"] = 0
proof = tm.Marlin.prove(pk, circ, rng, device="cpu")
got = proof.to_bytes()
length, bound, n_mul = round2[0]
res["domains_mixed"] = (h, k) == (96, 288) and bool(n_mul & (n_mul - 1))
res["h_1_trimmed"] = length > bound  # the trim of prover_second_round cut this h_1
res["mixed_transforms_ran"] = ntt.MIXED_TRANSFORMS["cpu"] > 0
res["proof_bytes_equal"] = got == want and (a2, b2) == (a, b)
res["verifies"] = bool(tm.Marlin.verify(vk, [a * b % R], proof, rng, device="cpu")
                       and not tm.Marlin.verify(vk, [(a * b + 1) % R], proof, rng, device="cpu"))
print("RESULT " + json.dumps(res), flush=True)
"""


@functools.lru_cache(maxsize=None)
def _run(prog: str, curve: str, cap: str | None) -> dict:
    env = dict(os.environ, MARLIN_TPU_CURVE=curve, JAX_PLATFORMS="cpu", MARLIN_TPU_XLA_CACHE="",
               TF_CPP_MIN_LOG_LEVEL="3", MARLIN_TPU_HOST_MSM="1", MARLIN_TPU_FUSE_ROUNDS="0",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("MARLIN_TPU_FR_TWO_ADICITY_CAP", None)
    if cap is not None:
        env["MARLIN_TPU_FR_TWO_ADICITY_CAP"] = cap
    res = subprocess.run([sys.executable, "-c", prog], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


SIZES = [3 * 8, 9 * 16, 27 * 8, 3 * 2048]


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("n", SIZES)
def test_mixed_transform_equals_the_reference(n, direction):
    assert _run(_NTT_PROG, "synthetic_lowadic", None)[f"{n}_{direction}"] is True


@pytest.mark.parametrize("n", SIZES)
def test_mixed_transform_batches_and_round_trips(n):
    assert _run(_NTT_PROG, "synthetic_lowadic", None)[f"{n}_batch"] is True


@pytest.mark.parametrize("check", ["ntt_many", "intt_many"])
def test_mixed_ntt_many_goes_per_polynomial(check):
    assert _run(_NTT_PROG, "synthetic_lowadic", None)[check] is True


@pytest.mark.parametrize("check", ["domains_mixed", "h_1_trimmed", "mixed_transforms_ran", "proof_bytes_equal",
                                   "verifies"])
def test_bn254_proof_on_mixed_domains_equals_the_jax_package(check):
    assert _run(_PROOF_PROG, "bn254", "6")[check] is True
