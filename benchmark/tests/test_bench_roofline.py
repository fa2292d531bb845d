"""The frozen work count of the fold, the trace's reduction and the metric
readers, on small hand-made inputs."""

from __future__ import annotations

import os

import pytest
import torch

from benchmark import harness, roofline, trace


def test_montgomery_product_and_mixed_add_counts():
    assert roofline.montgomery_muls(12) == 288
    assert roofline.montgomery_muls(8) == 128
    assert roofline.MIXED_ADD_PRODUCTS == 11


def test_fold_work_at_a_small_shape():
    # lanes of 3, 0 and 1 filled slots: 2 + 0 + 0 additions
    layout = torch.tensor([[1, -2, 3, 0], [0, 0, 0, 0], [0, 2, 0, 0]], dtype=torch.int32)
    filled = (layout != 0).sum(1).tolist()
    rows = int(torch.unique(layout.abs()[layout != 0]).numel())
    ops, nbytes = roofline.fold_work(filled, rows, 3, 4, 12)
    assert ops == 2 * 11 * 288
    assert nbytes == 3 * 96 + 3 * 4 * 4 + 3 * (3 * 96 + 4)
    assert roofline.least_seconds(ops, nbytes) == max(ops / roofline.PEAK_INT_MULS_PER_S,
                                                      nbytes / roofline.PEAK_BYTES_PER_S)


def test_the_peaks():
    assert roofline.PEAK_INT_MULS_PER_S == pytest.approx(8.363e12, rel=1e-3)
    assert roofline.PEAK_BYTES_PER_S == 3.35e12


def record():
    spans = [("Marlin::Prover", 0, 0.0, 2.0), ("AHP::Prover::FirstRound", 1, 1.0, 1.2),
             ("Committing to first round polys", 1, 1.2, 1.5), ("msm jobs: dispatch", 2, 1.25, 1.4),
             (trace.OPEN_SPAN, 1, 1.6, 1.9),
             ("Marlin::Prover", 0, 2.0, 4.0), ("AHP::Prover::FirstRound", 1, 3.0, 3.3)]
    return {
        "window": [0.0, 4.0], "proves": [(0.0, 2.0), (2.0, 4.0)], "synthesis": [(0.1, 0.6), (2.1, 2.5)],
        "spans": spans, "busy": [[1.25, 1.4], [3.0, 3.1]], "busy_s": 0.25,
        "kernel_seconds": {"fold_kernel<false>": 0.2, "binop_kernel": 0.05},
        "fold": {"launches": 2, "least_s": 0.1, "device_s": 0.2},
        "num_proves": 2, "counters": {"launches": 30, "exact_reruns": 1},
        "setup": {"key_load_s": 3.0, "warmup_s": 4.0}, "memory_peak_bytes": 2**31,
    }


def reader(name):
    return harness.load_file(os.path.join(harness.BENCH_DIR, "metrics", f"{name}.py"), f"_t_{name}").read


def test_the_readers_on_a_small_record():
    rec = record()
    assert reader("synthesis_s")(rec) == pytest.approx((0.5 + 0.4) / 2)
    assert reader("ahp_rounds_s")(rec) == pytest.approx((0.2 + 0.3) / 2)
    assert reader("commit_s")(rec) == pytest.approx((0.3 + 0.3) / 2)
    # 4.0 s of Marlin::Prover, less 1.1 s of depth-1 spans, less 0.9 s of synthesis
    assert reader("unspanned_s")(rec) == pytest.approx((4.0 - 1.1 - 0.9) / 2)
    assert reader("msm_reruns_per_prove")(rec) == 0.5
    assert reader("launches_per_prove")(rec) == 15
    assert reader("fold_roofline_pct")(rec) == pytest.approx(50.0)
    assert reader("device_idle_pct")(rec) == pytest.approx(100 * (1 - 0.25 / 4.0))
    assert reader("peak_mem_gib")(rec) == 2.0
    assert reader("key_load_s")(rec) == 3.0 and reader("warmup_s")(rec) == 4.0


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = record()
    rec["fold"] = {"launches": 0, "least_s": 0.0, "device_s": 0.0}
    rec["busy_s"] = 0.0
    rec["spans"] = []
    assert reader("fold_roofline_pct")(rec) is None
    assert reader("device_idle_pct")(rec) is None
    assert reader("ahp_rounds_s")(rec) is None
    assert reader("unspanned_s")(rec) is None


def test_merge_and_breakdown():
    assert trace._merge([(0, 1), (0.5, 2), (3, 4), (4, 4)]) == [[0, 2], [3, 4]]
    b = trace.breakdown(record())
    assert b["device_ops"][0] == ["fold_kernel<false>", 0.2]
    idle = dict(b["idle_gaps"])
    # gaps 0-1.25 (its middle past the first synthesis), 1.4-3.0 (its middle
    # in the second synthesis) and 3.1-4.0 (past the round's span)
    assert idle["Marlin::Prover outside its phase spans"] == pytest.approx(1.25 + 0.9)
    assert idle["synthesis (benchmark)"] == pytest.approx(1.6)
    assert sum(idle.values()) == pytest.approx(4.0 - 0.25)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
