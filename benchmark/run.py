#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  Set-up
(kernel build at first use, the keys from benchmark/cache/ or, the first
time, made and archived there, warm-up proves) then a window of
`--seconds` of proves, then the plain reference's check of every proof of
the window.  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer metrics), `device` (and with `--trace 1`
`breakdown`) and, last, `compared`: each number the check compared, with
its limit.  The same numbers end standard error.

Exits with a nonzero code and prints no result when there is no CUDA card,
when the cell asks for more cards than there are, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.read_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    spec = harness.cell(bench, args.workload)
    chips = int(spec["workload"]["chips"])
    harness.prepare_environment(spec["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    run = harness.Run(spec, args.seed, args.seconds, bool(args.trace))
    run.setup()
    setup_s = harness.process_seconds()
    run.window()
    device = run.release()
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": device["kind"], "count": chips,
              "memory_peak_bytes": device["memory_peak_bytes"]}
    out = {"correct": None, "attempted": len(run.proves), "failed": None}
    if args.trace:
        from benchmark import trace

        device.update(busy_s=run.record["busy_s"], window_s=run.window_s)
        out["metrics"] = run.per_layer(device["memory_peak_bytes"])
        out["breakdown"] = trace.breakdown(run.record)
    else:
        out["metrics"] = run.end_to_end(setup_s)
    device["power_limit"] = harness.power_limit()
    out["device"] = device
    compared, out["failed"] = run.judge()
    out["correct"] = harness.decide(compared, out["failed"], out["attempted"])
    out["setup_parts"] = run.setup_parts
    out["diagnostics"] = run.diagnostics
    out["compared"] = compared
    for name, c in compared.items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
