"""The window's arithmetic on a fake clock: proves that straddle
`--seconds` finish inside the window, the rate counts every prove over the
whole window, and a prove that raises is counted and judged as failed."""

from __future__ import annotations

import types

from benchmark import harness

from .conftest import small_spec


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def fake_run(prove_seconds: float, seconds: float, fail_at=()):
    spec = small_spec("sonic381-2p16-stream")
    run = harness.Run(spec, 7, seconds, False, device="cpu")
    clock = FakeClock()
    run.clock = clock
    calls = []

    def prove(pk, circuit, rng, device=None):
        calls.append(circuit)
        clock.t += prove_seconds
        if len(calls) in fail_at:
            raise RuntimeError("planted failure")
        return types.SimpleNamespace(to_bytes=lambda: b"", evaluations=[])

    run.cls = types.SimpleNamespace(prove=prove)
    run.P = types.SimpleNamespace(R_MODULUS=101, FR_BITS=7)
    run.ZkRng = lambda seed: seed
    run.pk = object()
    run.Circuit = lambda r, a, b, n, v, timings: (a, b)
    return run, calls


def test_proves_begun_before_the_end_finish_inside_the_window():
    run, calls = fake_run(3.0, 10.0)
    run.window()
    # proves start at 0, 3, 6 and 9 s: the last one ends at 12 s
    assert len(run.proves) == len(calls) == 4
    assert run.window_s == 12.0
    rate = run.end_to_end(5.0)["constraints_per_s"]["value"]
    assert rate == 4 * run.config["num_constraints"] / 12.0


def test_a_prove_longer_than_the_window_still_counts():
    run, _ = fake_run(25.0, 10.0)
    run.window()
    assert len(run.proves) == 1 and run.window_s == 25.0


def test_a_failed_prove_is_attempted_and_failed(capsys):
    run, _ = fake_run(3.0, 10.0, fail_at=(2,))
    run.window()
    assert len(run.proves) == 4
    assert [p is None for _, _, p, _ in run.proves] == [False, True, False, False]
    assert "planted failure" in capsys.readouterr().err


def test_witnesses_come_from_the_seed_alone():
    a = harness.witness_stream(2**40 + 3, 0, 2**61 - 1, 61)
    b = harness.witness_stream(2**40 + 3, 0, 2**61 - 1, 61)
    c = harness.witness_stream(2**40 + 3, 1, 2**61 - 1, 61)
    first = [next(a) for _ in range(5)]
    assert first == [next(b) for _ in range(5)]
    assert first != [next(c) for _ in range(5)]
    assert all(0 <= x < 2**61 - 1 and 0 <= y < 2**61 - 1 for x, y, _ in first)
    # any whole number is a seed, the negative and the very large too
    next(harness.witness_stream(-5, 0, 101, 7))
    next(harness.witness_stream(2**70, 0, 101, 7))


def test_correct_needs_a_proof_and_every_number_within_its_limit():
    ok = {"proofs_rejected": {"value": 0, "limit": 0}}
    assert harness.decide(ok, 0, 3)
    assert not harness.decide(ok, 0, 0)
    assert not harness.decide(ok, 1, 3)
    assert not harness.decide({"proofs_rejected": {"value": 1, "limit": 0}}, 0, 3)
