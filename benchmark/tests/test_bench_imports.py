"""No run loads JAX or the JAX package, by whole top-level names, and the
reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
import types

from benchmark import harness

ROOT = harness.ROOT


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "marlin_tpu_torch_like", types.ModuleType("marlin_tpu_torch_like"))
    assert "marlin_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "marlin_tpu.snark", types.ModuleType("marlin_tpu.snark"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax", "marlin_tpu"]


def subprocess_json(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_loads_nothing_of_the_program():
    got = subprocess_json(
        f"import sys, json; sys.path.insert(0, {ROOT!r})\n"
        "from benchmark.reference.judge import Judge\n"
        "cfg = {'curve': 'bn254', 'scheme': 'MarlinSonic', 'circuit': 'dummy', 'num_constraints': 64,"
        " 'num_variables': 10, 'universal_setup': [64, 64, 192]}\n"
        "Judge(cfg, 3)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not {"marlin_tpu_torch", "marlin_tpu", "jax", "jaxlib", "torch"} & set(got)


def test_a_cpu_run_loads_no_jax(tmp_path):
    got = subprocess_json(
        f"import sys, json; sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import harness\n"
        f"harness.CACHE_DIR = {str(tmp_path)!r}\n"
        "from benchmark.tests.conftest import small_spec\n"
        "spec = small_spec('bn254kzg-2p16-stream')\n"
        "harness.prepare_environment(spec['config'])\n"
        "run = harness.Run(spec, 9, 0.2, False, device='cpu')\n"
        "run.setup(); run.window(); run.release(); compared, failed = run.judge()\n"
        "print(json.dumps({'forbidden': harness.forbidden_modules(), 'failed': failed,"
        " 'curve': run.P.CURVE_NAME}))")
    assert got == {"forbidden": [], "failed": 0, "curve": "bn254"}
