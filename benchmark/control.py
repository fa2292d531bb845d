#!/usr/bin/env python3
"""Readings of the check that decides `correct`, on the program's proofs
with one guarantee broken (the control) and with faults planted.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] --proofs <k>
        [--kinds sound false_statement no_hiding altered_answer] [--device cuda]

One process sets up as a run does (the same keys, the same warm-up), then
for each kind and seed proves `k` statements drawn from the seed as the
window would, and judges each proof with the plain reference:

* `sound`: the cell's own proves; the lower reading.
* `false_statement` (the control): the circuit assigns the input
  c = a*b + 1, a statement its witness does not satisfy, and each proof is
  judged as a proof of that statement.  It breaks the configuration's
  guarantee that every proof verifies for the statement it claims, so a
  check worth its name rejects every one.
* `no_hiding`: the commitments' blinding polynomials are zero (the
  zero-knowledge guarantee broken: the step a later change that drops the
  blinding MSMs would take).
* `altered_answer`: one evaluation of each proof altered where the prove
  returns it.
* `other_setup`: the cell's own proves, judged by a reference whose setup
  seed is the configuration's plus one: keys made by another setup.

Prints one JSON line a kind and seed: the numbers `correct` compares
(`proofs_rejected`, `index_comms_differing`) and the proofs judged.  It is
no part of a run: the benchmark's runs never start it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

KINDS = ("sound", "false_statement", "no_hiding", "altered_answer", "other_setup")


class FalseStatement:
    """The cell's circuit with its input assigned a*b + 1."""

    def __init__(self, circuit_cls):
        self.circuit_cls = circuit_cls

    def __call__(self, r, a, b, n, v, timings):
        c = self.circuit_cls(r, a, b, n, v, timings)
        inner = c.generate_constraints

        def generate_constraints(cs):
            orig = cs.new_input_variable
            cs.new_input_variable = lambda fn=None: orig(None if fn is None else (lambda: (a * b + 1) % r))
            try:
                inner(cs)
            finally:
                del cs.new_input_variable
        c.generate_constraints = generate_constraints
        return c


@contextlib.contextmanager
def no_hiding():
    """Zero blinding polynomials in both commitment schemes."""
    from marlin_tpu_torch.snark import kzg, sonic

    saved = (kzg._rand_blind, sonic._rand_blind)
    zero = lambda hiding_bound, rng: [0] * (hiding_bound + 2)
    kzg._rand_blind = sonic._rand_blind = zero
    try:
        yield
    finally:
        kzg._rand_blind, sonic._rand_blind = saved


def alter(proof):
    """One evaluation of a proof changed, as if the prove returned it wrong."""
    proof.evaluations = [(proof.evaluations[0] + 1)] + proof.evaluations[1:]
    return proof


def readings(run, judge, kind: str, seed: int, proofs: int) -> dict:
    r = run.P.R_MODULUS
    stream = harness.witness_stream(seed, 0, r, run.P.FR_BITS)
    circuit_cls = FalseStatement(run.Circuit) if kind == "false_statement" else run.Circuit
    rejected = 0
    reasons: dict = {}
    for _ in range(proofs):
        a, b, zk = next(stream)
        circuit = circuit_cls(r, a, b, run.config["num_constraints"], run.config["num_variables"], [])
        ctx = no_hiding() if kind == "no_hiding" else contextlib.nullcontext()
        with ctx:
            proof = run.cls.prove(run.pk, circuit, run.ZkRng(zk), device=run.device)
        if kind == "altered_answer":
            proof = alter(proof)
        public = [(a * b + 1) % r] if kind == "false_statement" else None
        failures = judge.proof_failures((a, b), proof.to_bytes(), public)
        rejected += bool(failures)
        for f in failures:
            reasons[f] = reasons.get(f, 0) + 1
    return {"proofs_rejected": rejected, "proofs": proofs, "reasons": reasons}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--proofs", type=int, required=True)
    ap.add_argument("--kinds", nargs="+", choices=KINDS, default=["sound", "false_statement"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    spec = harness.cell(bench, args.workload)
    harness.prepare_environment(spec["config"])
    from benchmark.reference.judge import Judge

    run = harness.Run(spec, args.seeds[0], 0.0, False, device=args.device)
    run.setup()
    program_comms = [c.comm for c in run.pk.index_vk.index_comms]
    for kind in args.kinds:
        judge = Judge(spec["config"], spec["config"]["setup_seed"] + (kind == "other_setup"))
        differing = judge.index_comms_differing(program_comms)
        for seed in args.seeds:
            out = {"workload": args.workload, "kind": kind, "seed": seed, "index_comms_differing": differing}
            out.update(readings(run, judge, kind, seed, args.proofs))
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
