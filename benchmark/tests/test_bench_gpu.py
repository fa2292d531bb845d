"""One short run of a cell on the card: the result line's shape and
`correct`.  Marked `gpu`; it skips on a machine without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(trace):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sonic381-2p16-stream",
                          "--seed", str(2**31 + 99), "--seconds", "3", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    assert line["correct"] and line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if trace:
        assert line["device"]["busy_s"] > 0 and "breakdown" in line
        assert 0 < line["metrics"]["fold_roofline_pct"]["value"] <= 100
    else:
        assert set(line["metrics"]) == {"constraints_per_s", "setup_s"}
