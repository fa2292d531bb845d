"""arkworks marlin's bench circuit, `DummyCircuit` (benches/bench.rs:25-67),
on the port's constraint system: witnesses a and b, the input c = a*b,
num_variables - 3 more witnesses, num_constraints - 1 constraints a * b = c
and one empty constraint.

Each call of `generate_constraints` appends its (start, end) host clock
readings to `timings`, which the harness reads as synthesis time.
"""

from __future__ import annotations

import time

from marlin_tpu_torch.snark.r1cs import lc


class Circuit:
    def __init__(self, r: int, a: int, b: int, num_constraints: int, num_variables: int,
                 timings: list | None = None):
        self.r = r
        self.a, self.b = a, b
        self.num_constraints = num_constraints
        self.num_variables = num_variables
        self.timings = timings if timings is not None else []

    def generate_constraints(self, cs) -> None:
        start = time.perf_counter()
        a = cs.new_witness_variable(lambda: self.a)
        b = cs.new_witness_variable(lambda: self.b)
        c = cs.new_input_variable(lambda: self.a * self.b % self.r)
        for _ in range(self.num_variables - 3):
            cs.new_witness_variable(lambda: self.a)
        for _ in range(self.num_constraints - 1):
            cs.enforce_constraint(lc(a), lc(b), lc(c))
        cs.enforce_constraint(lc(), lc(), lc())
        self.timings.append((start, time.perf_counter()))
