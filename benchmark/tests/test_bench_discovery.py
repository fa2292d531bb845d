"""BENCHMARK.json against the contract's shape, and every name it gives
found as a file: configurations, traffic mixes, circuits and metric readers."""

from __future__ import annotations

import os
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its time: 2 + 14 x 24 runs, 90 s twice a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in BENCH["end_to_end"] + BENCH["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in BENCH["end_to_end"] + BENCH["per_layer"])


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())


@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_finds_its_files_by_name(workload):
    spec = harness.cell(BENCH, workload)
    cfg = spec["config"]
    assert cfg["scheme"] in harness.SCHEMES
    for key in ("curve", "circuit", "num_constraints", "num_variables", "universal_setup", "setup_seed",
                "source", "assumed", "reduced"):
        assert key in cfg, key
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "circuits", f"{cfg['circuit']}.py"))
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "reference", "circuits", f"{cfg['circuit']}.py"))
    assert spec["traffic"]["arrivals"] == "closed"
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"} and len(spec["end_to_end"]) >= 2
    assert spec["per_layer"], "every cell reports a per-layer metric"
    assert spec["workload"]["chips"] in (1, 4)


def test_configs_state_their_source_and_cuts():
    for entry in BENCH["configs"]:
        cfg = harness.read_json(os.path.join(harness.ROOT, entry["file"]))
        assert entry["file"].startswith("benchmark/")
        assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]
        assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    reader = harness.load_file(os.path.join(harness.BENCH_DIR, "metrics", f"{metric}.py"), f"_t_{metric}")
    assert callable(reader.read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {x["layer"] for x in BENCH["per_layer"]}
    assert all("\n" not in layer for layer in layers)


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.cell(BENCH, "no-such-cell")


def test_the_environment_holds_only_the_configurations_settings(monkeypatch):
    monkeypatch.setenv("MARLIN_TPU_MSM_TABLE", "0")
    monkeypatch.setenv("MARLIN_TPU_TRACE", "1")
    monkeypatch.setattr(os, "environ", dict(os.environ))
    harness.prepare_environment({"curve": "bn254", "env": {"MARLIN_TPU_FIXED_C": 12}})
    port = {k: v for k, v in os.environ.items() if k.startswith("MARLIN_TPU_")}
    assert port == {"MARLIN_TPU_CURVE": "bn254", "MARLIN_TPU_FIXED_C": "12"}
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        assert os.environ[k].startswith(harness.CACHE_DIR)
