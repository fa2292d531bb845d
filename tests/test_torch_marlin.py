"""The whole slice: the port's Marlin against the JAX package's, on the CPU.

The JAX side runs in a subprocess with `MARLIN_TPU_HOST_MSM=1` (the host
MSM route, the port's only MSM in this slice) and
`MARLIN_TPU_FUSE_ROUNDS=0`: `_round_jit` reads the fusion switch at import
time, so a fresh process is the one reliable place to set it.  It proves
the one-constraint circuit under `test_rng()` and hands back its proof
bytes and, through `marlin_tpu_torch.interop.to_plain`, its SRS and
index keys.  The port proves the same statement on the CPU meanwhile.

Proof bytes are compared for exact equality: both packages follow the
same transcript and zk-rng order over exact field arithmetic, so a single
differing bit is a fault.
"""

import json
import os
import pickle
import subprocess
import sys

import pytest

from marlin_tpu_torch import interop
from marlin_tpu_torch.snark.data_structures import Proof
from marlin_tpu_torch.snark.marlin import Marlin
from marlin_tpu_torch.snark.r1cs import lc
from marlin_tpu_torch.utils.rand import test_rng as seeded_rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_SIDE = r"""
import json, pickle, sys
from marlin_tpu import Marlin
from marlin_tpu.snark.r1cs import lc
from marlin_tpu.utils.rand import test_rng
from marlin_tpu_torch.interop import to_plain

class C:
    def generate_constraints(self, cs):
        x = cs.new_witness_variable(lambda: 3)
        y = cs.new_witness_variable(lambda: 5)
        out = cs.new_input_variable(lambda: 15)
        cs.enforce_constraint(lc(x), lc(y), lc(out))

rng = test_rng()
srs = Marlin.universal_setup(32, 32, 96, rng)
pk, vk = Marlin.index(srs, C())
proof = Marlin.prove(pk, C(), rng)
ok = Marlin.verify(vk, [15], proof, rng)
with open(sys.argv[1], "wb") as f:
    pickle.dump({"srs": to_plain(srs), "pk": to_plain(pk), "proof": proof.to_bytes(),
                 "verifies": ok}, f)
"""


class OneConstraint:
    """x * y = out with x = 3, y = 5, out = 15 (public)."""

    def generate_constraints(self, cs):
        x = cs.new_witness_variable(lambda: 3)
        y = cs.new_witness_variable(lambda: 5)
        out = cs.new_input_variable(lambda: 15)
        cs.enforce_constraint(lc(x), lc(y), lc(out))


def _rng_after_setup():
    rng = seeded_rng()
    rng.rand_fr(), rng.rand_fr()  # setup draws tau and gamma
    return rng


def _rejects(vk, inputs, proof_bytes) -> bool:
    try:
        proof = Proof.from_bytes(proof_bytes)
    except ValueError:
        return True
    return not Marlin.verify(vk, inputs, proof, seeded_rng(), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_side") / "state.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", MARLIN_TPU_HOST_MSM="1",
               MARLIN_TPU_FUSE_ROUNDS="0", MARLIN_TPU_XLA_CACHE="", TF_CPP_MIN_LOG_LEVEL="3",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        rng = seeded_rng()
        srs = Marlin.universal_setup(32, 32, 96, rng, device="cpu")
        pk, vk = Marlin.index(srs, OneConstraint(), device="cpu")
        proof = Marlin.prove(pk, OneConstraint(), rng, device="cpu")
        log, _ = jax_proc.communicate(timeout=900)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        jax_state = pickle.load(f)
    return {"vk": vk, "proof": proof.to_bytes(), "jax": jax_state}


def test_cpu_proof_is_byte_identical_to_jax(runs):
    assert runs["jax"]["verifies"]
    assert len(runs["proof"]) == 855
    assert runs["proof"] == runs["jax"]["proof"]


def test_port_verifier_accepts_jax_proof_and_rejects_tampering(runs):
    vk, jax_proof = runs["vk"], runs["jax"]["proof"]
    assert Marlin.verify(vk, [15], Proof.from_bytes(jax_proof), seeded_rng(), device="cpu")
    assert _rejects(vk, [16], jax_proof)
    flipped = bytearray(jax_proof)
    flipped[len(flipped) // 2] ^= 0x01
    assert _rejects(vk, [15], bytes(flipped))


def test_jax_verifier_accepts_port_proof(runs):
    from marlin_tpu.snark.data_structures import IndexVerifierKey
    from marlin_tpu.snark.data_structures import Proof as JaxProof
    from marlin_tpu.snark.indexer import IndexInfo
    from marlin_tpu.snark.kzg import Commitment, VerifierKey
    from marlin_tpu.snark.marlin import Marlin as JaxMarlin
    from marlin_tpu.utils.rand import test_rng as jax_test_rng

    plain = runs["jax"]["pk"]["index_vk"]
    vkp = plain["verifier_key"]
    jvk = IndexVerifierKey(
        index_info=IndexInfo(**plain["index_info"]),
        index_comms=[Commitment(**c) for c in plain["index_comms"]],
        verifier_key=VerifierKey(**vkp),
    )
    port_proof = JaxProof.from_bytes(runs["proof"])
    assert JaxMarlin.verify(jvk, [15], port_proof, jax_test_rng())
    assert not JaxMarlin.verify(jvk, [16], port_proof, jax_test_rng())


def test_proof_from_jax_srs_via_interop_is_identical(runs):
    srs = interop.universal_params(runs["jax"]["srs"], "cpu")
    pk, vk = Marlin.index(srs, OneConstraint(), device="cpu")
    proof = Marlin.prove(pk, OneConstraint(), _rng_after_setup(), device="cpu")
    assert proof.to_bytes() == runs["jax"]["proof"]
    assert vk.to_bytes() == runs["vk"].to_bytes()


def test_proof_from_jax_index_keys_via_interop_is_identical(runs):
    pk, vk = interop.index_keys(runs["jax"]["pk"], "cpu")
    proof = Marlin.prove(pk, OneConstraint(), _rng_after_setup(), device="cpu")
    assert proof.to_bytes() == runs["jax"]["proof"]
    assert Marlin.verify(vk, [15], proof, seeded_rng(), device="cpu")


def test_to_plain_leaves_only_plain_data(runs):
    """interop.to_plain leaves only plain data (no package objects)."""

    def walk(v):
        if isinstance(v, dict):
            return all(isinstance(k, (str, int)) and walk(x) for k, x in v.items())
        if isinstance(v, (list, tuple)):
            return all(walk(x) for x in v)
        return v is None or isinstance(v, (int, str, bytes, bool)) or hasattr(v, "dtype")

    assert walk(runs["jax"]["pk"]) and walk(runs["jax"]["srs"])
    json.dumps(runs["jax"]["pk"]["index_vk"]["index_info"])
