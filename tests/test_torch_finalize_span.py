"""The prove's `R1CS::finalize` span and the benchmark's readers of it.

A CPU prove, its spans recorded as a traced run records them
(`benchmark/trace.py`'s timed span), has one `R1CS::finalize` at depth 1
inside `Marlin::Prover`, before the first round; on a synthetic record,
`finalize_s` reads the span while `ahp_rounds_s` reads only the rounds and
`unspanned_s` leaves the span out, so `finalize_s` and `unspanned_s` sum
to what `unspanned_s` read without the span.  `r1cs.STATS` counts the
Weight goal's work of each finalize.
"""

import os

import pytest
import torch

from benchmark import harness
from benchmark.trace import Tracer
from marlin_tpu_torch.snark import r1cs
from marlin_tpu_torch.snark.marlin import Marlin
from marlin_tpu_torch.snark.r1cs import ConstraintSystem, SynthesisMode, lc
from marlin_tpu_torch.utils import profiling, rand
from torch_threads import one_thread  # noqa: F401

SPAN = "R1CS::finalize"


def reader(name: str):
    return harness.load_file(os.path.join(harness.BENCH_DIR, "metrics", f"{name}.py"), f"_test_metric_{name}").read


class Product:
    """x * y = out, out public."""

    def generate_constraints(self, cs):
        x = cs.new_witness_variable(lambda: 3)
        y = cs.new_witness_variable(lambda: 5)
        out = cs.new_input_variable(lambda: 15)
        cs.enforce_constraint(lc(x), lc(y), lc(out))


@pytest.fixture
def traced_spans():
    """The spans of one CPU prove, as (name, depth, start, end)."""
    rng = rand.test_rng()
    srs = Marlin.universal_setup(16, 16, 48, rng, device="cpu")
    pk, _ = Marlin.index(srs, Product(), device="cpu")
    tracer = Tracer(torch, Marlin.PC, "cpu")
    tracer._patch(profiling, "span", tracer._timed_span)
    enabled = profiling.is_enabled()
    profiling.enable(True)
    try:
        Marlin.prove(pk, Product(), rng, device="cpu")
    finally:
        profiling.enable(enabled)
        for obj, name, original in reversed(tracer._restore):
            setattr(obj, name, original)
        profiling.collect()
    return tracer.spans


def test_finalize_is_one_span_at_depth_1_inside_the_prover_before_the_rounds(traced_spans):
    (prover,) = [s for s in traced_spans if s[0] == "Marlin::Prover"]
    (span,) = [s for s in traced_spans if s[0] == SPAN]
    first = next(s for s in traced_spans if s[0] == "AHP::Prover::FirstRound")
    assert prover[1] == 0 and span[1] == 1
    assert prover[2] <= span[2] <= span[3] <= first[2] <= prover[3]
    rec = {"spans": traced_spans, "synthesis": [], "num_proves": 1}
    assert reader("finalize_s")(rec) == pytest.approx(span[3] - span[2])
    rounds = sum(e - s for n, _, s, e in traced_spans if n.startswith("AHP::Prover::"))
    assert reader("ahp_rounds_s")(rec) == pytest.approx(rounds)


def synthetic(finalize: bool, proves: int) -> dict:
    """`proves` proves of 10 s: synthesis 1 s, finalize 1.5 s, rounds 2 s,
    a commitment 1 s (an MSM span inside it, depth 2)."""
    spans, synthesis = [], []
    for k in range(proves):
        t = 10.0 * k
        spans += [("Marlin::Prover", 0, t, t + 10), ("AHP::Prover::FirstRound", 1, t + 4, t + 5),
                  ("Committing to first round polys", 1, t + 5, t + 6), ("msm jobs: dispatch", 2, t + 5.1, t + 5.5),
                  ("AHP::Prover::SecondRound", 1, t + 6, t + 6.5), ("AHP::Prover::ThirdRound", 1, t + 7, t + 7.5)]
        if finalize:
            spans.append((SPAN, 1, t + 1.5, t + 3))
        synthesis.append((t + 0.5, t + 1.5))
    return {"spans": spans, "synthesis": synthesis, "num_proves": proves}


@pytest.mark.parametrize("proves", [1, 3])
def test_the_readers_with_and_without_the_span(proves):
    with_span, without = synthetic(True, proves), synthetic(False, proves)
    assert reader("finalize_s")(with_span) == pytest.approx(1.5)
    assert reader("finalize_s")(without) is None  # a program without the span reads nothing
    assert reader("ahp_rounds_s")(with_span) == reader("ahp_rounds_s")(without) == pytest.approx(2.0)
    assert reader("unspanned_s")(without) == pytest.approx(10 - 1 - 3)
    assert reader("unspanned_s")(with_span) == pytest.approx(10 - 1 - 3 - 1.5)


def test_stats_count_the_weight_goals_work():
    """An LC of three terms read by three rows outlines (t*l = 12 > t + 2 + l
    = 9); one of a single term read twice does not (3 > 6 fails)."""
    cs = ConstraintSystem(mode=SynthesisMode.SETUP)
    x, y, z = (cs.new_witness_variable() for _ in range(3))
    s = cs.new_lc(lc(x, y, z))
    u = cs.new_lc(lc(x))
    cs.enforce_constraint(lc(s), lc(s), lc(s))
    cs.enforce_constraint(lc(u), lc(u), lc())
    before = dict(r1cs.STATS)
    cs.finalize()
    delta = {k: r1cs.STATS[k] - before[k] for k in before}
    assert delta == {"finalizes": 1, "lcs": 8, "outlined": 1, "inlined_terms": 5}
    assert cs.num_constraints == 3 and cs.num_witness_variables == 4
