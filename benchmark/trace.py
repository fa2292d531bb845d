"""What a `--trace 1` run records over its window, and the reduction of it.

`Tracer` is a context manager around the window.  It turns on the
program's phase spans (marlin_tpu_torch/utils/profiling.py: each span
synchronizes the card at both ends) and times each one on the host clock,
adds one span of its own around the commitment scheme's opening
(`PC.open_combinations`, which the program does not span), notes the
inputs of every bucket fold (kernel 5) for its work count, and runs
`torch.profiler` over the card.  `record()` reduces all of it to plain
numbers and lists that the metric readers and the breakdown read.

Device and host times share one clock: a marker kernel launched right
after the profiler starts is the trace's first device event, and its start
is taken as the host time read just before its launch.
"""

from __future__ import annotations

import contextlib
import time

from . import roofline

OPEN_SPAN = "Opening the linear combinations (benchmark)"
FOLD_SYMBOL = "fold_kernel"


class Tracer:
    def __init__(self, torch, pc_module, device):
        from marlin_tpu_torch.fields import active as P
        from marlin_tpu_torch.ops import curve
        from marlin_tpu_torch.utils import profiling

        self.torch = torch
        self.profiling = profiling
        self.curve = curve
        self.pc = pc_module
        self.device = device
        self.fq_words = P.FQ_BYTES // 4
        self.spans: list = []  # (name, depth, start, end)
        self.folds: list = []  # (ops, bytes)
        self._depth = 0
        self._restore: list = []
        self.events: list = []  # (name, start_s, end_s) on the host clock

    # -- instrumentation -------------------------------------------------
    def _timed_span(self, original):
        tracer = self

        @contextlib.contextmanager
        def span(name):
            depth = tracer._depth
            tracer._depth += 1
            start = None
            try:
                with original(name):
                    start = time.perf_counter()
                    yield
            finally:
                tracer._depth -= 1
                if start is not None:
                    tracer.spans.append((name, depth, start, time.perf_counter()))
        return span

    def _opening(self, original):
        tracer = self

        def open_combinations(*args, **kwargs):
            with tracer.profiling.span(OPEN_SPAN):
                return original(*args, **kwargs)
        return open_combinations

    def _fold(self, original):
        tracer = self
        torch = self.torch

        def bucket_fold_kernel(table, layout, exact=False, subrows=None):
            lanes, cap = layout.shape
            nz = layout != 0
            filled = nz.sum(1).tolist()
            rows = int(torch.unique(layout.abs()[nz]).numel())
            tracer.folds.append(roofline.fold_work(filled, rows, lanes, cap, tracer.fq_words))
            return original(table, layout, exact, subrows)
        return bucket_fold_kernel

    def _patch(self, obj, name, wrapper):
        original = getattr(obj, name)
        setattr(obj, name, wrapper(original))
        self._restore.append((obj, name, original))

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._patch(self.profiling, "span", self._timed_span)
        self._patch(self.pc, "open_combinations", self._opening)
        self._patch(self.curve, "bucket_fold_kernel", self._fold)
        self.profiling.enable(True)
        torch = self.torch
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._marker_host = time.perf_counter()
        torch.ones(1, device=self.device).add_(1)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        self.profiling.enable(False)
        for obj, name, original in reversed(self._restore):
            setattr(obj, name, original)
        self._restore.clear()
        self._collect()
        return False

    def _collect(self) -> None:
        from torch.autograd import DeviceType

        raw = []
        for ev in self._prof.events():
            if getattr(ev, "device_type", None) == DeviceType.CUDA:
                raw.append((ev.name, ev.time_range.start, ev.time_range.end))
        raw.sort(key=lambda e: e[1])
        if not raw:
            return
        # the marker is the first device event: align the trace's clock to the host's
        offset = self._marker_host - raw[0][1] / 1e6
        self.events = [(name, s / 1e6 + offset, e / 1e6 + offset) for name, s, e in raw[1:]]

    # -- reduction ---------------------------------------------------------
    def record(self, window: tuple, synthesis: list) -> dict:
        """Plain numbers over the window [start, end]: the spans, the device's
        busy intervals, kernel time by name, the folds' work and time."""
        w0, w1 = window
        busy = _merge([(max(s, w0), min(e, w1)) for _, s, e in self.events if e > w0 and s < w1])
        by_kernel: dict = {}
        fold_s = 0.0
        for name, s, e in self.events:
            by_kernel[name] = by_kernel.get(name, 0.0) + (e - s)
            if FOLD_SYMBOL in name:
                fold_s += e - s
        fold_least = sum(roofline.least_seconds(ops, nb) for ops, nb in self.folds)
        return {
            "window": [w0, w1],
            "synthesis": synthesis,
            "spans": self.spans,
            "busy_s": sum(e - s for s, e in busy),
            "busy": busy,
            "kernel_seconds": by_kernel,
            "fold": {"launches": len(self.folds), "least_s": fold_least, "device_s": fold_s},
        }


def _merge(intervals: list) -> list:
    out: list = []
    for s, e in sorted(i for i in intervals if i[1] > i[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of the
    device summed by what the host was doing: the innermost span around the
    middle of each gap (the benchmark's synthesis, a program span,
    'Marlin::Prover outside its phase spans', or 'outside spans')."""
    ops = sorted(rec["kernel_seconds"].items(), key=lambda kv: -kv[1])[:top]
    spans = list(rec["spans"]) + [("synthesis (benchmark)", 1, s, e) for s, e in rec["synthesis"]]
    w0, w1 = rec["window"]
    edges = [w0] + [t for iv in rec["busy"] for t in iv] + [w1]
    idle: dict = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        inner = max((sp for sp in spans if sp[2] <= mid < sp[3]), key=lambda sp: sp[1], default=None)
        if inner is None:
            name = "outside spans"
        elif inner[1] == 0:
            name = f"{inner[0]} outside its phase spans"
        else:
            name = inner[0]
        idle[name] = idle.get(name, 0.0) + (e - s)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[_short(n), v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps]}


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."
