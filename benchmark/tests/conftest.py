"""Fixtures of the benchmark's CPU tests: a cell cut to a size the CPU
proves in seconds, and a key cache of the test's own."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

SMALL = 64


def small_spec(workload: str, n: int = SMALL) -> dict:
    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    spec = harness.cell(bench, workload)
    spec["config"] = dict(spec["config"], num_constraints=n, universal_setup=[n, n, 3 * n])
    return spec


@pytest.fixture
def key_cache(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path / "cache"
