"""Judging a run's output against the plain reference.

`Judge` takes a configuration (its curve, its scheme, its circuit's sizes)
and the setup seed the benchmark handed the program.  It works out the
setup's trapdoor from that seed, the circuit's R1CS from its own copy of
the circuit, the index polynomials' values at the trapdoor and so the six
index commitments; then it reads what the program produced only to judge
it: the index commitments of the program's verifier key, and each proof's
bytes with the statement it claims.
"""

from __future__ import annotations

import importlib.util
import os

from . import index as ix
from .curves import CURVES, G1
from .transcript import setup_trapdoor
from .verify import check

_HERE = os.path.dirname(os.path.abspath(__file__))


def circuit_module(name: str):
    path = os.path.join(_HERE, "circuits", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_reference_circuit_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def srs_max_degree(curve, num_constraints: int, num_variables: int, num_non_zero: int) -> int:
    """The SRS degree of universal_setup(n, v, m) (arkworks marlin
    src/ahp/mod.rs:71-93, zero-knowledge bound 1)."""
    h = ix.domain_size(curve, max(num_variables, num_constraints))
    k = ix.domain_size(curve, num_non_zero)
    return max(2 * h - 1, 3 * h - 1, h, k - 1)


class Judge:
    def __init__(self, config: dict, setup_seed: int):
        self.curve = CURVES[config["curve"]]
        self.scheme = {"Marlin": "marlin", "MarlinSonic": "sonic"}[config["scheme"]]
        self.g1 = G1(self.curve)
        self.trapdoor = setup_trapdoor(self.curve, setup_seed)
        n, v = config["num_constraints"], config["num_variables"]
        self.max_degree = srs_max_degree(self.curve, *config["universal_setup"])
        self.circuit = circuit_module(config["circuit"])
        num_instance, a, b, c = self.circuit.matrices(n, v)
        self.info, evals = ix.index_evals(self.curve, a, b, c, num_instance)
        values = ix.values_at(self.curve, evals, self.trapdoor[0])
        self.index_comms = [self.g1.mul(self.curve.gen, values[label]) for label in ix.INDEX_LABELS]

    def index_comms_differing(self, program_comms: list) -> int:
        """How many of the program's six index commitments (affine (x, y),
        None for the identity) differ from the reference's."""
        if len(program_comms) != len(self.index_comms):
            return len(self.index_comms)
        return sum(1 for p, q in zip(program_comms, self.index_comms) if p != q)

    def proof_failures(self, witness: tuple, proof: bytes, public: list | None = None) -> list:
        """What fails in one proof of the statement that the witness (a, b)
        makes, or of `public` where given; empty when the proof verifies."""
        if public is None:
            public = self.circuit.public_input(self.curve.r, *witness)
        return check(self.curve, self.scheme, self.info, self.index_comms, self.max_degree,
                     self.trapdoor, public, proof)
