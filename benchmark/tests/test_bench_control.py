"""The rest of a run on the CPU, with the chip's look skipped, at 2^6
constraints: sound, it comes out correct; with the timed path broken
underneath, `correct` comes out false, once for each fault the cell can
have (an answer altered where it is produced, a prove that fails) and for
the control (a false statement) and the zero-knowledge guarantee broken.
Half a batch left out, a state left unchanged and the exchange between
chips do not exist in a cell of one closed-loop prover on one chip."""

from __future__ import annotations

import contextlib

import pytest

from benchmark import control, harness

from .conftest import small_spec


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    saved = harness.CACHE_DIR
    harness.CACHE_DIR = str(tmp_path_factory.mktemp("keys"))
    try:
        run = harness.Run(small_spec("sonic381-2p16-stream"), 2**33 + 1, 1e-6, False, device="cpu")
        run.setup()
        yield run
    finally:
        harness.CACHE_DIR = saved


def run_once(prepared, wrap_prove=None, circuit=None, ctx=contextlib.nullcontext):
    """A window of one prove (a CPU prove at 2^6 outlasts the 0.2 s) on the
    prepared keys, then the check."""
    run = harness.Run(prepared.spec, 2**33 + 2, 0.2, False, device="cpu")
    for attr in ("torch", "P", "ZkRng", "Circuit", "pk"):
        setattr(run, attr, getattr(prepared, attr))
    run.cls = prepared.cls
    if circuit is not None:
        run.Circuit = circuit(prepared.Circuit)
    original = run.cls.prove
    if wrap_prove is not None:
        run.cls = type("Patched", (prepared.cls,), {"prove": classmethod(
            lambda cls, *a, **k: wrap_prove(original, *a, **k))})
    with ctx():
        run.window()
    run.release()
    compared, failed = run.judge()
    return harness.decide(compared, failed, len(run.proves)), compared


def test_a_sound_run_is_correct(prepared):
    correct, compared = run_once(prepared)
    assert correct
    assert compared["proofs_rejected"]["value"] == 0
    assert compared["index_comms_differing"]["value"] == 0


def test_an_answer_altered_where_it_is_produced_fails(prepared):
    correct, compared = run_once(prepared, wrap_prove=lambda f, *a, **k: control.alter(f(*a, **k)))
    assert not correct and compared["proofs_rejected"]["value"] == 1


def test_a_prove_that_fails_fails(prepared):
    def broken(f, *a, **k):
        raise RuntimeError("planted")
    correct, _ = run_once(prepared, wrap_prove=broken)
    assert not correct


def test_the_control_a_false_statement_fails(prepared):
    correct, compared = run_once(prepared, circuit=control.FalseStatement)
    assert not correct and compared["proofs_rejected"]["value"] == 1


def test_proofs_without_blinding_fail(prepared):
    correct, compared = run_once(prepared, ctx=control.no_hiding)
    assert not correct and compared["proofs_rejected"]["value"] == 1


def test_index_keys_other_than_the_references_fail(prepared):
    from benchmark.reference.judge import Judge

    judge = Judge(prepared.config, prepared.config["setup_seed"] + 1)
    assert judge.index_comms_differing([c.comm for c in prepared.pk.index_vk.index_comms]) == 6


def test_the_control_script_reads_each_kind(prepared):
    from benchmark.reference.judge import Judge

    judge = Judge(prepared.config, prepared.config["setup_seed"])
    other = Judge(prepared.config, prepared.config["setup_seed"] + 1)
    got = {kind: control.readings(prepared, other if kind == "other_setup" else judge, kind, 5, 1)["proofs_rejected"]
           for kind in control.KINDS}
    assert got == {"sound": 0, "false_statement": 1, "no_hiding": 1, "altered_answer": 1, "other_setup": 1}
