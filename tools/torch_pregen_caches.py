#!/usr/bin/env python3
"""Pre-generate the SRS and index-key caches of the PyTorch/CUDA port.

    python3 tools/torch_pregen_caches.py [--device cpu]

The port's counterpart of tools/pregen_caches.py: the same
`PREGEN_CONFIGS` (a comma list of log2n:pc pairs, default
"16:marlin,16:sonic,18:marlin") over the bench circuit (`DummyCircuit`,
reference benches/bench.rs), the same cache names (`srs_<curve>_<degree>
[_sonic].npz`, `bench_idx_<n>[_sonic]_{pk,vk}.npz`, the prover key
without its SRS), in the port's own directory `~/.cache/marlin_tpu_torch_srs`.
Setup and index run on the card unless `--device cpu`; the archives are
the same either way, and load in either package (snark/serial.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pregen(configs: str, device, cache_dir: str) -> None:
    from chip_smoke import DummyCircuit
    from marlin_tpu_torch.snark import ahp, serial
    from marlin_tpu_torch.snark.marlin import Marlin, MarlinSonic
    from marlin_tpu_torch.utils.rand import test_rng

    t0 = time.perf_counter()
    for item in configs.split(","):
        log2n, pc = item.strip().split(":")
        n = 1 << int(log2n)
        M = MarlinSonic if pc == "sonic" else Marlin
        suffix = "" if pc == "marlin" else f"_{pc}"
        pk_path = os.path.join(cache_dir, f"bench_idx_{n}{suffix}_pk.npz")
        vk_path = os.path.join(cache_dir, f"bench_idx_{n}{suffix}_vk.npz")
        rng = test_rng()
        a, b = rng.rand_fr(), rng.rand_fr()
        circ = DummyCircuit(a, b, num_variables=10, num_constraints=n)
        print(f"[pregen +{time.perf_counter() - t0:7.1f}s] SRS 2^{log2n} {pc}", flush=True)
        srs = serial.cached_srs(ahp.max_degree(n, n, 3 * n), rng, cache_dir=cache_dir,
                                flavor="sonic" if pc == "sonic" else "marlin", device=device)
        if os.path.exists(pk_path) and os.path.exists(vk_path):
            print(f"[pregen] index keys already cached: {pk_path}", flush=True)
            continue
        print(f"[pregen +{time.perf_counter() - t0:7.1f}s] index 2^{log2n} {pc}", flush=True)
        pk, vk = M.index(srs, circ, device=device)
        serial.save_index_pk(pk, pk_path, include_srs=False)
        serial.save_index_vk(vk, vk_path)
        print(f"[pregen +{time.perf_counter() - t0:7.1f}s] cached {pk_path}", flush=True)
    print(f"[pregen] done in {time.perf_counter() - t0:.1f}s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help='the device to set up and index on (default: the card; "cpu")')
    ap.add_argument("--cache-dir", default=os.path.expanduser("~/.cache/marlin_tpu_torch_srs"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.makedirs(args.cache_dir, exist_ok=True)
    pregen(os.environ.get("PREGEN_CONFIGS", "16:marlin,16:sonic,18:marlin"), args.device, args.cache_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
