"""Archives of the port (marlin_tpu_torch.snark.serial) against the JAX
package's (marlin_tpu.snark.serial), on the CPU.

Both packages set up and index a 16-constraint `DummyCircuit` (the
bench circuit of tests/test_marlin_sharded.py) under `test_rng()` and write its SRS, its
index prover key (with the SRS and without) and its verifier key.  The
JAX side runs in a subprocess with `MARLIN_TPU_HOST_MSM=1` and
`MARLIN_TPU_FUSE_ROUNDS=0` (as in tests/test_torch_marlin.py); it also
loads the port's archives and proves from them.  Checked here:

* the two packages' archives hold the same arrays (names, dtypes, limbs)
  and the same metadata;
* the JAX package's archives load in the port, and the port's in the JAX
  package; the keys loaded either way prove the JAX package's proof bytes,
  and the lean key reattaches to a loaded SRS;
* the port's prove under a mesh of four CPU devices (`mesh=`), with the
  NTT threshold lowered so that |H| = 16 shards, gives the same bytes;
* each tampered archive of tests/test_serialization.py, an off-curve G1
  power, a limb >= 2^16, a non-affine Z and a residue >= q raise
  `ValueError` in both packages;
* `cached_srs` makes, then loads, an archive in its own directory.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from marlin_tpu.snark import serial as jserial
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.ops import fq
from marlin_tpu_torch.parallel import context as pctx
from marlin_tpu_torch.parallel import ntt_sharded
from marlin_tpu_torch.parallel.multihost import Mesh
from marlin_tpu_torch.snark import serial
from marlin_tpu_torch.snark.marlin import Marlin
from marlin_tpu_torch.snark.r1cs import lc
from marlin_tpu_torch.utils.rand import test_rng as seeded_rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = P.R_MODULUS
A, B, NC = 11, 13, 16
ARCHIVES = ("srs", "pk", "lean", "vk")

_JAX_SIDE = r"""
import json, sys
from circuits import DummyCircuit, R
from marlin_tpu import Marlin
from marlin_tpu.snark import serial
from marlin_tpu.snark.data_structures import Proof
from marlin_tpu.utils.rand import test_rng

out, a, b, nc = sys.argv[1], *map(int, sys.argv[2:5])
circ = DummyCircuit(a, b, num_variables=10, num_constraints=nc)
rng = test_rng()
srs = Marlin.universal_setup(nc, nc, 3 * nc, rng)
pk, vk = Marlin.index(srs, circ)
serial.save_srs(srs, f"{out}/jax_srs.npz")
serial.save_index_pk(pk, f"{out}/jax_pk.npz")
serial.save_index_pk(pk, f"{out}/jax_lean.npz", include_srs=False)
serial.save_index_vk(vk, f"{out}/jax_vk.npz")
proof = Marlin.prove(pk, circ, rng).to_bytes()


def after_setup():
    r = test_rng()
    r.rand_fr(), r.rand_fr()  # setup draws tau and gamma
    return r


srs_p = serial.load_srs(f"{out}/port_srs.npz")
vk_p = serial.load_index_vk(f"{out}/port_vk.npz")
from_port = {
    name: Marlin.prove(serial.load_index_pk(f"{out}/port_{name}.npz", **kw), circ, after_setup()).to_bytes()
    for name, kw in (("pk", {}), ("lean", {"srs": srs_p}))
}
ok = Marlin.verify(vk_p, [a * b % R], Proof.from_bytes(from_port["pk"]), after_setup())
with open(f"{out}/jax.json", "w") as f:
    json.dump({"proof": proof.hex(), "from_port": {k: v.hex() for k, v in from_port.items()},
               "verifies_with_port_vk": ok, "vk_bytes": vk.to_bytes().hex(),
               "port_vk_bytes": vk_p.to_bytes().hex()}, f)
"""

class DummyCircuit:
    """The bench circuit (reference benches/bench.rs:25-67), over the port's
    constraint system; tests/circuits.py holds the JAX package's."""

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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the plain versions' tensors are
    small, so one thread runs them as fast alone and far faster beside the
    other test workers than a pool that spins on every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _after_setup():
    rng = seeded_rng()
    rng.rand_fr(), rng.rand_fr()  # setup draws tau and gamma
    return rng


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's keys and archives, the JAX side's archives and proofs."""
    out = tmp_path_factory.mktemp("archives")
    rng = seeded_rng()
    circ = DummyCircuit(A, B, num_variables=10, num_constraints=NC)
    srs = Marlin.universal_setup(NC, NC, 3 * NC, rng, device="cpu")
    pk, vk = Marlin.index(srs, circ, device="cpu")
    serial.save_srs(srs, str(out / "port_srs.npz"))
    serial.save_index_pk(pk, str(out / "port_pk.npz"))
    serial.save_index_pk(pk, str(out / "port_lean.npz"), include_srs=False)
    serial.save_index_vk(vk, str(out / "port_vk.npz"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", MARLIN_TPU_HOST_MSM="1",
               MARLIN_TPU_FUSE_ROUNDS="0", MARLIN_TPU_XLA_CACHE="", TF_CPP_MIN_LOG_LEVEL="3",
               PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(out), str(A), str(B), str(NC)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out / "jax.json") as f:
        jax_side = json.load(f)
    return {"dir": out, "srs": srs, "pk": pk, "vk": vk, "circ": circ, "jax": jax_side}


def _path(runs, who, name):
    return str(runs["dir"] / f"{who}_{name}.npz")


@pytest.mark.parametrize("name", ARCHIVES)
def test_both_packages_write_the_same_archive(runs, name):
    with np.load(_path(runs, "port", name)) as p, np.load(_path(runs, "jax", name)) as j:
        assert sorted(p.files) == sorted(j.files)
        assert json.loads(str(p["meta"])) == json.loads(str(j["meta"]))
        for k in p.files:
            assert p[k].dtype == j[k].dtype and np.array_equal(p[k], j[k]), k


def test_jax_archives_load_in_the_port_and_prove_the_jax_bytes(runs):
    srs = serial.load_srs(_path(runs, "jax", "srs"), device="cpu")
    vk = serial.load_index_vk(_path(runs, "jax", "vk"), device="cpu")
    assert vk.to_bytes() == runs["vk"].to_bytes()
    assert srs.g == runs["srs"].g and srs.beta_h == runs["srs"].beta_h
    assert all(torch.equal(a, b) for a, b in zip(srs.powers_of_g, runs["srs"].powers_of_g))
    want = bytes.fromhex(runs["jax"]["proof"])
    for name, kw in (("pk", {}), ("lean", {"srs": srs})):
        pk = serial.load_index_pk(_path(runs, "jax", name), device="cpu", **kw)
        proof = Marlin.prove(pk, runs["circ"], _after_setup(), device="cpu")
        assert proof.to_bytes() == want, name
    assert Marlin.verify(vk, [A * B % R], proof, seeded_rng(), device="cpu")
    assert not Marlin.verify(vk, [A * B % R + 1], proof, seeded_rng(), device="cpu")


def test_port_archives_load_in_the_jax_package(runs):
    jax_side = runs["jax"]
    assert jax_side["verifies_with_port_vk"]
    assert jax_side["port_vk_bytes"] == jax_side["vk_bytes"] == runs["vk"].to_bytes().hex()
    assert jax_side["from_port"] == {"pk": jax_side["proof"], "lean": jax_side["proof"]}


def test_mesh_prove_from_loaded_keys_gives_the_jax_bytes(runs, monkeypatch):
    """|H| = 16 with the NTT threshold lowered to 16 (tests/test_marlin_sharded.py
    lowers it to 128 for |H| = 256): every round transform runs four-step."""
    monkeypatch.setattr(pctx, "NTT_MIN_SHARDED", 16)
    calls = []
    four_step = ntt_sharded.ntt_4step_resident
    monkeypatch.setattr(ntt_sharded, "ntt_4step_resident", lambda *a, **k: calls.append(1) or four_step(*a, **k))
    pk = serial.load_index_pk(_path(runs, "jax", "pk"), device="cpu")
    mesh = Mesh(np.array([torch.device("cpu")] * 4, dtype=object), ("x",))
    proof = Marlin.prove(pk, runs["circ"], _after_setup(), device="cpu", mesh=mesh)
    assert proof.to_bytes().hex() == runs["jax"]["proof"]
    assert len(calls) > 0 and pctx.current() is None


def test_a_loaded_key_refuses_an_srs_on_another_device(runs):
    with pytest.raises(ValueError, match="lives on cpu"):
        serial.load_index_pk(_path(runs, "port", "lean"), srs=runs["srs"], device="meta")
    with pytest.raises(ValueError, match="no SRS"):
        serial.load_index_pk(_path(runs, "port", "lean"), device="cpu")


def _limbs(v: int) -> np.ndarray:
    return np.asarray([(v >> (16 * i)) & 0xFFFF for i in range(fq.L)], dtype=np.uint32)


def _rewrite(path, arrays, meta):
    np.savez(path, meta=json.dumps(meta, default=str), **arrays)


def _tamper(case, arrays, meta):
    """Each case of tests/test_serialization.py, then the power checks."""
    q = P.Q_MODULUS
    if case == "vk_comm":  # a commitment's x off the curve
        meta["index_comms"][0]["comm"][0] = int(meta["index_comms"][0]["comm"][0]) ^ 1
    elif case == "vk_g":
        meta["verifier_key"]["g"][1] = int(meta["verifier_key"]["g"][1]) ^ 1
    elif case == "srs_beta_h":
        meta["beta_h"][0][0] = int(meta["beta_h"][0][0]) ^ 1
    elif case == "off_curve_power":  # a valid residue, another point's y
        arrays["pg_y"][3] = arrays["pg_y"][4]
    elif case == "limb":
        arrays["pg_x"][2, 0] = 1 << 16
    elif case == "z":
        arrays["pgg_z"][5] = arrays["pgg_x"][5]
    elif case == "residue":  # x + q: the same value mod q, limbs below 2^16
        x = sum(int(v) << (16 * i) for i, v in enumerate(arrays["pg_x"][1]))
        arrays["pg_x"][1] = _limbs(x + q)


TAMPER = {"vk_comm": "vk", "vk_g": "vk", "srs_beta_h": "srs", "off_curve_power": "srs",
          "limb": "srs", "z": "srs", "residue": "srs"}


@pytest.mark.parametrize("case", sorted(TAMPER))
def test_a_tampered_archive_raises_in_both_packages(runs, case, tmp_path):
    kind = TAMPER[case]
    with np.load(_path(runs, "port", kind)) as z:
        arrays = {k: z[k].copy() for k in z.files if k != "meta"}
        meta = json.loads(str(z["meta"]))
    _tamper(case, arrays, meta)
    path = str(tmp_path / f"{case}.npz")
    _rewrite(path, arrays, meta)
    port_load = {"srs": serial.load_srs, "vk": serial.load_index_vk}[kind]
    jax_load = {"srs": jserial.load_srs, "vk": jserial.load_index_vk}[kind]
    with pytest.raises(ValueError) as port_err:
        port_load(path, device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_load(path)
    assert str(port_err.value) == str(jax_err.value)


def test_a_tampered_srs_inside_a_prover_key_raises(runs, tmp_path):
    """The port checks the powers a prover-key archive carries as load_srs
    checks an SRS's (the JAX package's load_index_pk does not)."""
    with np.load(_path(runs, "port", "pk")) as z:
        arrays = {k: z[k].copy() for k in z.files if k != "meta"}
        meta = json.loads(str(z["meta"]))
    arrays["srs_pg_y"][3] = arrays["srs_pg_y"][4]
    path = str(tmp_path / "pk.npz")
    _rewrite(path, arrays, meta)
    with pytest.raises(ValueError, match="off-curve"):
        serial.load_index_pk(path, device="cpu")


def test_cached_srs_makes_then_loads_in_its_own_directory(tmp_path):
    made = serial.cached_srs(40, seeded_rng(), cache_dir=str(tmp_path), flavor="sonic", device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["srs_bls12381_40_sonic.npz"]
    loaded = serial.cached_srs(40, None, cache_dir=str(tmp_path), flavor="sonic", device="cpu")
    assert loaded.neg_powers_of_h == made.neg_powers_of_h and loaded.beta_h == made.beta_h
    assert all(torch.equal(a, b) for a, b in zip(loaded.powers_of_gamma_g, made.powers_of_gamma_g))
