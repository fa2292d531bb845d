"""Phase timing spans.

Analog of the reference's `start_timer!/end_timer!` tracing (87
sites, SURVEY.md §5.1): nested wall-clock spans with the same phase names so
per-phase numbers are comparable.  Enable with MARLIN_TPU_TRACE=1 or
`enable()`; `collect()` returns structured records for bench output.

Kernels run asynchronously on the card, so an enabled span synchronizes the
device at its start and end (when CUDA is in use): its seconds then include
the device work launched inside it.  Disabled spans cost nothing.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

_enabled = os.environ.get("MARLIN_TPU_TRACE", "0") == "1"
_depth = 0
_records: list[dict] = []


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def collect() -> list[dict]:
    """Drain and return recorded spans."""
    global _records
    out, _records = _records, []
    return out


@contextlib.contextmanager
def span(name: str):
    global _depth
    if not _enabled:
        yield
        return
    _depth += 1
    _sync_device()
    start = time.perf_counter()
    print(f"{'··' * (_depth - 1)}Start: {name}", flush=True)
    try:
        yield
    finally:
        _sync_device()
        elapsed = time.perf_counter() - start
        _depth -= 1
        _records.append({"name": name, "seconds": elapsed, "depth": _depth})
        print(f"{'··' * _depth}End: {name} {elapsed * 1e3:.3f}ms", flush=True)


def _sync_device() -> None:
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def is_enabled() -> bool:
    return _enabled
