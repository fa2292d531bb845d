"""The plain reference against the port's CPU path at 2^6-2^8 constraints:
the same index commitments, the port's proofs accepted, altered ones and
proofs of another statement rejected; its transcript and the setup's
sampler against the port's.  BN254 runs in a process of its own (the port
chooses its curve once a process)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.reference import transcript
from benchmark.reference.curves import CURVES
from benchmark.reference.judge import Judge

ROOT = harness.ROOT

CHECK = r'''
import json, os, sys
sys.path.insert(0, {root!r})
from benchmark import harness
from benchmark.reference.judge import Judge
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.snark import marlin
from marlin_tpu_torch.utils.rand import ZkRng
n, scheme = {n}, {scheme!r}
cfg = {{"curve": P.CURVE_NAME, "scheme": scheme, "circuit": "dummy", "num_constraints": n,
        "num_variables": 10, "universal_setup": [n, n, 3 * n], "setup_seed": 77}}
cls = getattr(marlin, scheme)
Circuit = harness.load_file(os.path.join(harness.BENCH_DIR, "circuits", "dummy.py"), "c").Circuit
srs = cls.universal_setup(n, n, 3 * n, ZkRng(77), device="cpu")
pk, vk = cls.index(srs, Circuit(P.R_MODULUS, 1, 2, n, 10), device="cpu")
judge = Judge(cfg, 77)
a, b = 1234567, 7654321
proof = cls.prove(pk, Circuit(P.R_MODULUS, a, b, n, 10), ZkRng(5), device="cpu").to_bytes()
bad = bytearray(proof)
bad[len(bad) // 2] ^= 4
print(json.dumps({{
    "index_differing": judge.index_comms_differing([c.comm for c in vk.index_comms]),
    "sound": judge.proof_failures((a, b), proof),
    "altered": judge.proof_failures((a, b), bytes(bad)),
    "other_statement": judge.proof_failures((a, b + 1), proof),
}}))
'''


def check(curve: str, n: int, scheme: str) -> dict:
    env = dict(os.environ, MARLIN_TPU_CURVE=curve)
    env.pop("MARLIN_TPU_FR_TWO_ADICITY_CAP", None)
    out = subprocess.run([sys.executable, "-c", CHECK.format(root=ROOT, n=n, scheme=scheme)],
                         capture_output=True, text=True, env=env, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("curve,n,scheme", [
    ("bls12_381", 64, "MarlinSonic"),
    ("bls12_381", 256, "Marlin"),
    ("bn254", 64, "Marlin"),
    ("bn254", 128, "MarlinSonic"),
])
def test_the_reference_judges_the_ports_cpu_proofs(curve, n, scheme):
    got = check(curve, n, scheme)
    assert got["index_differing"] == 0
    assert got["sound"] == []
    assert got["altered"] != []
    assert got["other_statement"] != []


@pytest.mark.parametrize("curve", ["bls12_381", "bn254"])
def test_the_transcript_is_the_ports(curve):
    env = dict(os.environ, MARLIN_TPU_CURVE=curve)
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "from marlin_tpu_torch.snark.fs import FiatShamirRng\n"
            "fs = FiatShamirRng(b'MARLIN-2019 test'); a = [fs.rand_fr() for _ in range(3)]\n"
            "fs.absorb(bytes(range(200))); a += [fs.rand_u128(), fs.rand_fr()]\n"
            "from marlin_tpu_torch.utils.rand import ZkRng\n"
            "z = ZkRng(2**35 + 11); a += [z.rand_fr(), z.rand_fr()]\n"
            "print(a)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    port = eval(out.stdout.strip())
    c = CURVES[curve]
    fs = transcript.Transcript(c, b"MARLIN-2019 test")
    mine = [fs.rand_fr() for _ in range(3)]
    fs.absorb(bytes(range(200)))
    mine += [fs.rand_u128(), fs.rand_fr()]
    mine += list(transcript.setup_trapdoor(c, 2**35 + 11))
    assert mine == port


def test_the_reference_refuses_a_domain_past_the_2_adicity():
    cfg = {"curve": "bn254", "scheme": "Marlin", "circuit": "dummy", "num_constraints": 2**29,
           "num_variables": 10, "universal_setup": [2**29, 2**29, 3 * 2**29]}
    with pytest.raises(ValueError):
        Judge(cfg, 1)
