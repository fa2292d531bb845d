#!/usr/bin/env python3
"""The mesh phases of chip_smoke.py alone, on a machine with one card or
several.

    python3 tools/mesh_smoke.py [--skip-sharded] [--out PATH]

Runs chip_smoke.py's phases build, main, serial (the archives the ranks
load; the window-width proves), sharded (a one-process mesh of four
shards: four cards where the machine has them) and distributed (two rank
processes, the layout by the card count: `chip_smoke.dist_layout`), each
printing one JSON line, without the kernel rows and the other curves.
`CUDA_VISIBLE_DEVICES` picks the layout on a machine of four cards (two
visible: rank r on card r twice).  Any failure exits nonzero.  Needs a
CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-sharded", action="store_true", help="leave out the one-process mesh phase")
    ap.add_argument("--out", help="also write every phase's record to this JSON file")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.environ["MARLIN_TPU_CURVE"] = "bls12_381"
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mesh_smoke: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    t0 = time.perf_counter()
    records = {}

    def emit(name, rec):
        rec = {"phase": name, **rec, "at_s": time.perf_counter() - t0}
        records[name] = rec
        print(json.dumps(rec, default=str), flush=True)

    emit("device", {"kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
                    "nvidia_smi": cs.nvidia_smi_line()})
    emit("build", cs.phase_build(torch))
    main_rec, state = cs.phase_main(torch)
    emit("main", main_rec)
    emit("serial", cs.phase_serial(torch, np, main_rec, state))
    sharded = {"steady_prove_s": {"sharded": None, "single": None}}
    if not args.skip_sharded:
        sharded = cs.phase_sharded(torch, np, state)
        emit("sharded", sharded)
    emit("distributed", cs.phase_distributed(torch, state, sharded))
    if args.out:
        cs._write(args.out, records)
    return 0


if __name__ == "__main__":
    sys.exit(main())
