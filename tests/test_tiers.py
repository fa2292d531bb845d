"""The test tiers: `xl` stays out of tier 1, of `-m slow` and of the default run, and is all of `-m xl`.

Tier 1 is `-m 'not slow'`.  pytest keeps only the last `-m` it is given, so
that expression replaces `pytest.ini`'s `-m "not xl"`; the repo's top-level
`conftest.py` then deselects the `xl` soaks from any run whose `-m` does not
name `xl`.  The collections below are of the real suite, in subprocesses
started together: one with no `-m` on the command line, one under `-m xl`,
one under tier 1's `-m 'not slow'` and one under `-m slow`.
"""

import importlib.util
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = {
    "tests/test_wide750.py::test_ahp_wide750_2_14",
    "tests/test_pallas.py::test_pallas_curve_add_double_match_xla",
    "tests/test_pallas.py::test_pallas_bucket_fold_matches_sum",
    "tests/test_pallas.py::test_pallas_bucket_fold_doubling_flag",
    "tests/test_pallas.py::test_pallas_combine_windows_matches_xla",
}


def _collect(*markexpr: str) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "pytest", "tests/", "--collect-only", "-q", *markexpr, "-n", "0",
           "-p", "no:cacheprovider", "-p", "no:randomly"]
    return subprocess.Popen(cmd, cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _ids(proc: subprocess.Popen) -> set:
    out, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, out[-2000:] + err[-2000:]
    return {ln.split("[")[0] for ln in out.splitlines() if "::" in ln}


@pytest.fixture(scope="module")
def collections():
    procs = {"default": _collect(), "xl": _collect("-m", "xl"),
             "not slow": _collect("-m", "not slow"), "slow": _collect("-m", "slow")}
    return {name: _ids(proc) for name, proc in procs.items()}


def test_xl_is_out_of_the_default_run_and_is_all_of_minus_m_xl(collections):
    assert collections["xl"] == XL
    assert not collections["default"] & XL
    assert "tests/test_tiers.py::test_xl_is_out_of_the_default_run_and_is_all_of_minus_m_xl" in collections["default"]


def test_tier_1_and_the_slow_tier_hold_no_xl(collections):
    assert not collections["not slow"] & XL
    assert not collections["slow"] & XL
    assert "tests/test_tiers.py::test_tier_1_and_the_slow_tier_hold_no_xl" in collections["not slow"]


@pytest.mark.parametrize("markexpr, runs_xl", [
    ("", False), ("not slow", False), ("slow", False), ("slow and not smoke", False),
    ("xl", True), ("not xl", True), ("slow or xl", True),
])
def test_the_xl_hook_steps_aside_only_when_the_expression_names_xl(markexpr, runs_xl):
    spec = importlib.util.spec_from_file_location("root_conftest", os.path.join(ROOT, "conftest.py"))
    root_conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_conftest)
    assert root_conftest._names_xl(markexpr) is runs_xl
