"""MarlinSonic: the port's proof against the JAX package's, on the CPU.

The JAX side runs in a subprocess with `MARLIN_TPU_HOST_MSM=1` (the host
MSM route, the port's route for an SRS on the CPU) and
`MARLIN_TPU_FUSE_ROUNDS=0` (read at import time, so a fresh process is the
one reliable place to set it), as tests/test_torch_marlin.py does.  It proves
the one-constraint circuit with `MarlinSonic` under `test_rng()` and hands
back its proof bytes and, through `marlin_tpu_torch.interop.to_plain`, its
Sonic SRS (with the negative G2 powers) and index keys.  The port proves the
same statement on the CPU meanwhile.

Proof bytes are compared for exact equality: both packages follow the same
transcript and zk-rng order over exact field arithmetic.
"""

import os
import pickle
import subprocess
import sys

import pytest

from marlin_tpu_torch import interop
from marlin_tpu_torch.snark.data_structures import Proof
from marlin_tpu_torch.snark.marlin import MarlinSonic
from marlin_tpu_torch.snark.r1cs import lc
from marlin_tpu_torch.snark.sonic import SonicVerifierKey
from marlin_tpu_torch.utils.rand import test_rng as seeded_rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_SIDE = r"""
import pickle, sys
from marlin_tpu.snark.marlin import MarlinSonic
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
srs = MarlinSonic.universal_setup(32, 32, 96, rng)
pk, vk = MarlinSonic.index(srs, C())
proof = MarlinSonic.prove(pk, C(), rng)
ok = MarlinSonic.verify(vk, [15], proof, rng)
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


def _flipped(proof_bytes: bytes) -> bytes:
    flipped = bytearray(proof_bytes)
    flipped[len(flipped) // 2] ^= 0x01
    return bytes(flipped)


def _rejects(vk, inputs, proof_bytes) -> bool:
    try:
        proof = Proof.from_bytes(proof_bytes)
    except ValueError:
        return True
    return not MarlinSonic.verify(vk, inputs, proof, seeded_rng(), device="cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sonic") / "state.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu", MARLIN_TPU_HOST_MSM="1",
               MARLIN_TPU_FUSE_ROUNDS="0", MARLIN_TPU_XLA_CACHE="", TF_CPP_MIN_LOG_LEVEL="3",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE, str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        rng = seeded_rng()
        srs = MarlinSonic.universal_setup(32, 32, 96, rng, device="cpu")
        pk, vk = MarlinSonic.index(srs, OneConstraint(), device="cpu")
        proof = MarlinSonic.prove(pk, OneConstraint(), rng, device="cpu")
        log, _ = jax_proc.communicate(timeout=900)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, log[-4000:]
    with open(out, "rb") as f:
        jax_state = pickle.load(f)
    return {"vk": vk, "proof": proof, "bytes": proof.to_bytes(), "jax": jax_state}


def test_cpu_sonic_proof_is_byte_identical_to_jax(runs):
    assert runs["jax"]["verifies"]
    assert isinstance(runs["vk"].verifier_key, SonicVerifierKey)
    assert all(c.shifted_comm is None for rc in runs["proof"].commitments for c in rc)
    assert len(runs["bytes"]) == 759
    assert runs["bytes"] == runs["jax"]["proof"]


def test_port_verifier_accepts_jax_sonic_proof_and_rejects_tampering(runs):
    vk, jax_proof = runs["vk"], runs["jax"]["proof"]
    assert MarlinSonic.verify(vk, [15], Proof.from_bytes(jax_proof), seeded_rng(), device="cpu")
    assert _rejects(vk, [16], jax_proof)
    assert _rejects(vk, [15], _flipped(jax_proof))


def test_jax_verifier_accepts_port_sonic_proof_and_rejects_tampering(runs):
    from marlin_tpu.snark.data_structures import IndexVerifierKey
    from marlin_tpu.snark.data_structures import Proof as JaxProof
    from marlin_tpu.snark.indexer import IndexInfo
    from marlin_tpu.snark.kzg import Commitment
    from marlin_tpu.snark.marlin import MarlinSonic as JaxMarlinSonic
    from marlin_tpu.snark.sonic import SonicVerifierKey as JaxSonicVerifierKey
    from marlin_tpu.utils.rand import test_rng as jax_test_rng

    plain = runs["jax"]["pk"]["index_vk"]
    jvk = IndexVerifierKey(
        index_info=IndexInfo(**plain["index_info"]),
        index_comms=[Commitment(**c) for c in plain["index_comms"]],
        verifier_key=JaxSonicVerifierKey(**plain["verifier_key"]),
    )
    port_proof = runs["bytes"]
    assert JaxMarlinSonic.verify(jvk, [15], JaxProof.from_bytes(port_proof), jax_test_rng())
    assert not JaxMarlinSonic.verify(jvk, [16], JaxProof.from_bytes(port_proof), jax_test_rng())
    try:
        tampered = JaxProof.from_bytes(_flipped(port_proof))
    except ValueError:
        return
    assert not JaxMarlinSonic.verify(jvk, [15], tampered, jax_test_rng())


def test_sonic_proof_from_jax_srs_via_interop_is_identical(runs):
    srs = interop.universal_params(runs["jax"]["srs"], "cpu")
    assert len(srs.neg_powers_of_h) == srs.max_degree() + 1
    pk, vk = MarlinSonic.index(srs, OneConstraint(), device="cpu")
    proof = MarlinSonic.prove(pk, OneConstraint(), _rng_after_setup(), device="cpu")
    assert proof.to_bytes() == runs["jax"]["proof"]
    assert vk.to_bytes() == runs["vk"].to_bytes()


def test_sonic_proof_from_jax_index_keys_via_interop_is_identical(runs):
    pk, vk = interop.index_keys(runs["jax"]["pk"], "cpu")
    assert isinstance(vk.verifier_key, SonicVerifierKey)
    proof = MarlinSonic.prove(pk, OneConstraint(), _rng_after_setup(), device="cpu")
    assert proof.to_bytes() == runs["jax"]["proof"]
    assert MarlinSonic.verify(vk, [15], proof, seeded_rng(), device="cpu")
