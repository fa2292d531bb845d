"""The benchmark's Poseidon Merkle membership circuit
(`benchmark/circuits/poseidon_merkle.py`) on the CPU, at depth 2 and
batches of 1 and 2.

In this process: the configuration states the circuit's own constants and
sizes, and the circuit refuses sizes, fields and batches that are not its
own.  Over BN254, in one subprocess (the port chooses its curve once a
process, and both packages read `MARLIN_TPU_CURVE`):

* the matrices and the assignment, padded, finalized and squared on the
  port's `ConstraintSystem`, equal the JAX package's;
* they equal the benchmark reference's own writing-out
  (`benchmark/reference/circuits/poseidon_merkle.py`), whose outline count
  equals the port's `r1cs.STATS`; setup mode gives the same matrices and
  computes no value;
* the reference's native Poseidon and tree equal the circuit's: each hash,
  the path bits and siblings in the witness, the public root and leaves,
  and the assignment satisfies the matrices;
* a whole CPU prove at depth 2 and batch 1 (the input padded from three
  to four) is accepted by the reference's `Judge`, and rejected as a proof
  of the same statement with one public leaf altered.
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from torch_threads import one_thread  # noqa: F401

ROOT = harness.ROOT
CIRCUIT = harness.load_file(os.path.join(harness.BENCH_DIR, "circuits", "poseidon_merkle.py"),
                            "_test_poseidon_merkle_circuit")
CONFIG = harness.read_json(os.path.join(harness.BENCH_DIR, "configs", "bn254-marlinkzg-poseidon-merkle20x14.json"))
SHAPES = [(2, 1), (2, 2)]

_PROG = r"""
import functools, json, os, types
import torch
torch.set_num_threads(1)
from benchmark import harness
from benchmark.reference import judge as judge_mod
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.snark import constraint_systems as tcs, marlin, r1cs as tr1
from marlin_tpu_torch.utils.rand import ZkRng
import marlin_tpu.snark.constraint_systems as jcs
import marlin_tpu.snark.r1cs as jr1

assert P.CURVE_NAME == "bn254"
R = P.R_MODULUS
circ = harness.load_file(os.path.join(harness.BENCH_DIR, "circuits", "poseidon_merkle.py"), "circuit")
ref = harness.load_file(os.path.join(harness.BENCH_DIR, "reference", "circuits", "poseidon_merkle.py"), "ref")
A, B = 1234567, 7654321


def synth(r1, cs_mod, depth, batch, prove=True):
    cs = r1.ConstraintSystem(mode=r1.SynthesisMode.PROVE if prove else r1.SynthesisMode.SETUP,
                             optimization_goal=r1.OptimizationGoal.WEIGHT)
    n, v = circ.sizes(depth, batch)
    circ.Circuit(R, A, B, n, v, None, depth, batch).generate_constraints(cs)
    cs_mod.pad_input_for_indexer_and_prover(cs)
    cs.finalize()
    cs_mod.make_matrices_square(cs)
    return cs


res = {}
for depth, batch in [(2, 1), (2, 2)]:
    key = f"{depth}x{batch}"
    port, jax = synth(tr1, tcs, depth, batch), synth(jr1, jcs, depth, batch)
    mats = port.to_matrices()
    res["jax_matrices_" + key] = mats == jax.to_matrices()
    res["jax_assignment_" + key] = port.full_assignment() == jax.full_assignment()
    n, v = circ.sizes(depth, batch)
    res["reference_matrices_" + key] = ref.matrices(n, v, depth, batch) == (port.num_instance_variables, *mats)

    for k in tr1.STATS:
        tr1.STATS[k] = 0
    setup = synth(tr1, tcs, depth, batch, prove=False)
    system = ref._synthesize(depth, batch)
    lcs = len(system.lcs)
    refs = sum(1 for lc in system.lcs for var in lc if var[0] == "lc")
    res["stats_" + key] = tr1.STATS == {"finalizes": 1, "lcs": lcs, "outlined": ref.outline(system),
                                        "inlined_terms": refs}
    res["setup_matrices_" + key] = setup.to_matrices() == mats and setup.witness_assignment == []

    res["satisfied_" + key] = port.is_satisfied()
    res["public_input_" + key] = port.instance_assignment[1:] == ref.public_input(R, A, B, depth, batch)
    pos, leaves, nodes = ref.tree(A, B, depth, batch)
    w, per_level = port.witness_assignment, 3 * circ.SBOXES + 3
    res["path_witness_" + key] = all(
        w[(i * depth + level) * per_level: (i * depth + level) * per_level + 2]
        == [(p >> level) & 1, nodes[(level, (p >> level) ^ 1)]]
        for i, p in enumerate(pos) for level in range(depth))
    poseidon = circ._Poseidon(R)
    res["tree_" + key] = circ.Circuit(R, A, B, n, v, None, depth, batch).tree(poseidon) == (pos, leaves, nodes)
res["poseidon"] = all(ref.poseidon(x, y) == circ._Poseidon(R).hash(x, y)
                      for x, y in [(0, 0), (1, 2), (R - 1, 5), (A * B % R, B)])

# a whole prove, judged by the reference
depth, batch = 2, 1
n, v = circ.sizes(depth, batch)
num_instance, a, b, c = ref.matrices(n, v, depth, batch)
nnz = sum(len(r) for r in tcs.sum_matrices(a, b, c))
size = len(a)
cfg = {"curve": "bn254", "scheme": "Marlin", "circuit": "poseidon_merkle", "num_constraints": n,
       "num_variables": v, "universal_setup": [size, size, nnz], "setup_seed": 41}
srs = marlin.Marlin.universal_setup(size, size, nnz, ZkRng(41), device="cpu")
pk, vk = marlin.Marlin.index(srs, circ.Circuit(R, 1, 2, n, v, None, depth, batch), device="cpu")
proof = marlin.Marlin.prove(pk, circ.Circuit(R, A, B, n, v, None, depth, batch), ZkRng(5), device="cpu").to_bytes()
small = types.SimpleNamespace(matrices=functools.partial(ref.matrices, depth=depth, batch=batch),
                              public_input=functools.partial(ref.public_input, depth=depth, batch=batch))
judge_mod.circuit_module = lambda name: small
judge = judge_mod.Judge(cfg, 41)
res["judge_index_comms"] = judge.index_comms_differing([cm.comm for cm in vk.index_comms]) == 0
res["judge_accepts"] = judge.proof_failures((A, B), proof) == []
public = ref.public_input(R, A, B, depth, batch)
public[1] = (public[1] + 1) % R
res["judge_rejects_an_altered_leaf"] = judge.proof_failures((A, B), proof, public) != []
print("RESULT " + json.dumps(res), flush=True)
"""

CHECKS = ([f"{name}_{d}x{b}" for name in ("jax_matrices", "jax_assignment", "reference_matrices", "stats",
                                          "setup_matrices", "satisfied", "public_input", "path_witness", "tree")
           for d, b in SHAPES]
          + ["poseidon", "judge_index_comms", "judge_accepts", "judge_rejects_an_altered_leaf"])


@pytest.fixture(scope="module")
def results() -> dict:
    env = dict(os.environ, MARLIN_TPU_CURVE="bn254", JAX_PLATFORMS="cpu", MARLIN_TPU_XLA_CACHE="",
               TF_CPP_MIN_LOG_LEVEL="3", OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("MARLIN_TPU_FR_TWO_ADICITY_CAP", None)
    out = subprocess.run([sys.executable, "-c", _PROG], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=480)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("check", CHECKS)
def test_the_circuit_agrees_with_the_jax_package_and_the_reference(results, check):
    assert results[check] is True


def test_the_configuration_states_the_circuits_constants_and_sizes():
    assert (CONFIG["depth"], CONFIG["batch"]) == (CIRCUIT.DEPTH, CIRCUIT.BATCH)
    assert CONFIG["poseidon"] == {"t": CIRCUIT.T, "alpha": CIRCUIT.ALPHA, "full_rounds": CIRCUIT.R_F,
                                  "partial_rounds": CIRCUIT.R_P}
    assert (CONFIG["num_constraints"], CONFIG["num_variables"]) == CIRCUIT.sizes()
    n, v, m = CONFIG["universal_setup"]
    # squared to 123,482: |H| = 2^17; the joint non-zeros (the chip run's index) fill |K| = 2^19
    assert n == v == max(CIRCUIT.sizes()) and 2**16 < n <= 2**17 and 2**18 < m <= 2**19


@pytest.mark.parametrize("depth, batch, sizes", [(1, 1, (440, 444)), (2, 3, (2640, 2651)), (20, 14, (123200, 123482))])
def test_the_sizes_are_the_finalized_counts(depth, batch, sizes):
    # counted by padding and finalizing the circuit on the port's constraint system
    assert CIRCUIT.sizes(depth, batch) == sizes


@pytest.mark.parametrize("args, match", [
    ((CIRCUIT.R_BN254, 1, 2, 123201, 123482), "synthesize"),
    ((CIRCUIT.R_BN254, 1, 2, 123200, 123481), "synthesize"),
    ((CIRCUIT.R_BN254 + 2, 1, 2, 123200, 123482), "BN254"),
    ((CIRCUIT.R_BN254, 1, 2, *CIRCUIT.sizes(1, 3), None, 1, 3), "fewer than 3 leaves"),
])
def test_the_circuit_refuses_what_it_does_not_synthesize(args, match):
    with pytest.raises(ValueError, match=match):
        CIRCUIT.Circuit(*args)
