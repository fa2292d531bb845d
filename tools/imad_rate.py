#!/usr/bin/env python3
"""The H100's integer multiply rate, and the latency of the port's chains.

    python3 tools/imad_rate.py [--out PATH]

(a) The rate of the Montgomery product's carry chains (IMAD.WIDE.U32 with
    carry) with every SM full: `imad_rate_kernel` of csrc/imad.cu at the
    occupancy calculator's resident blocks on each SM.  Its multiplies are
    counted in this build's SASS (tools/sass_count.py: the R = 8 instance
    less the R = 4 one is four rows), so the rate is in the unit of the
    operation bounds (SASS multiplies of one Fq or Fr product, times
    products).  Reported per second over the card, and per clock on one SM
    (the clock from the kernel's own clock64 span).
(b) The latency of one dependent Fq and one dependent Fr product on one
    thread (`product_chain_kernel`, x = x y, checked against host integers),
    and of one doubling step of the chain kernels (csrc/chain.cu: the window
    combine with W = 2, whose window 1 doubles c times), four lanes a
    chain.

The kernels are built from marlin_tpu_torch/csrc by ops/cuda.py, like every
other.  Prints one JSON object (and writes it to `--out`).  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

RATE_TARGET_MS = 20.0
PRODUCT_ITERS = 4096
DOUBLING_ITERS = 1024


def _event_ms(torch, launch) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    launch()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def rate(torch) -> dict:
    """(a): multiplies a second over the card and a clock on one SM."""
    import sass_count

    from marlin_tpu_torch.ops import cuda

    lib = cuda.lib()
    sass = sass_count.count(cuda.lib_path())["kernels"]
    m4, m8 = sass["imad_rate (4 rows)"]["multiplies"], sass["imad_rate (8 rows)"]["multiplies"]
    per_row = (m8 - m4) / 4  # SASS multiplies of one row of the kernel's 4 chains
    per_iter = 8 * per_row
    bps, threads = ctypes.c_int(0), ctypes.c_int(0)
    cuda.check(lib.marlin_imad_rate_shape(ctypes.byref(bps), ctypes.byref(threads)), "imad_rate_shape")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * bps.value
    dev = torch.device("cuda")
    inp = torch.randint(0, 1 << 31, (12,), dtype=torch.int32, device=dev)
    out = torch.empty(blocks * threads.value, dtype=torch.int32, device=dev)
    cycles = torch.zeros(blocks, dtype=torch.int64, device=dev)
    stream = cuda.stream_handle(out)

    def launch(iters):
        return lambda: cuda.check(lib.marlin_imad_rate(8, inp.data_ptr(), blocks, iters, out.data_ptr(),
                                                       cycles.data_ptr(), stream), "imad_rate")

    probe = 64
    launch(probe)()
    torch.cuda.synchronize()
    iters = max(probe, int(probe * RATE_TARGET_MS / max(_event_ms(torch, launch(probe)), 1e-3)))
    ms = _event_ms(torch, launch(iters))
    span = int(cycles.max())
    total = blocks * threads.value * iters * per_iter
    return {
        "sass_multiplies_per_row": per_row, "ptx_pairs_per_row": 4 * 6,
        "sms": sms, "blocks": blocks, "threads_per_block": threads.value, "iters": iters,
        "ms": ms, "clock64_span_cycles": span, "clock_mhz": span / (ms * 1e3),
        "multiplies_per_s": total / (ms * 1e-3),
        "multiplies_per_clock_per_sm": total / (span * sms),
    }


def product_latency(torch, field: str, iters: int = PRODUCT_ITERS) -> dict:
    """(b): one thread's dependent products x = x y, checked on the host."""
    import random

    from marlin_tpu_torch.ops import cuda, fq, fr

    mod = {"fq": fq, "fr": fr}[field]
    ctx = mod.CTX
    rnd = random.Random(7)
    x, y = rnd.randrange(1, ctx.modulus), rnd.randrange(1, ctx.modulus)
    dev = torch.device("cuda")
    inp = mod.from_ints([x, y], dev).contiguous()
    out = torch.empty(ctx.L, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = cuda.lib()
    field_id = cuda.FIELD_IDS[ctx.name]

    def launch(n):
        return lambda: cuda.check(lib.marlin_product_chain(field_id, inp.data_ptr(), n, out.data_ptr(),
                                                           cycles.data_ptr(), cuda.stream_handle(out)),
                                  "product_chain")

    launch(16)()
    torch.cuda.synchronize()
    ms = _event_ms(torch, launch(iters))
    got = mod.to_ints(out[None].cpu())[0]
    if got != x * pow(y, iters, ctx.modulus) % ctx.modulus:
        raise RuntimeError(f"product_chain ({field}) disagrees with the host")
    return {"iters": iters, "ms": ms, "us_per_product": ms * 1e3 / iters,
            "cycles_per_product": int(cycles.item()) / iters}


def doubling_latency(torch, iters: int = DOUBLING_ITERS) -> dict:
    """(b): one doubling step of the chain kernels, from the combine at W = 2."""
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd

    pts = cd.from_affine_ints([hc.G1_GEN, hc.g1_mul(hc.G1_GEN, 3)], "cuda")
    stacked = tuple(t[:, None].contiguous() for t in pts)
    curve.combine_windows_kernel(stacked, 1)
    torch.cuda.synchronize()
    ms = _event_ms(torch, lambda: curve.combine_windows_kernel(stacked, iters))
    return {"iters": iters, "ms": ms, "us_per_doubling": ms * 1e3 / iters}


def measure(torch) -> dict:
    return {
        "rate": rate(torch),
        "latency": {
            "fq_product": product_latency(torch, "fq"),
            "fr_product": product_latency(torch, "fr"),
            "doubling": doubling_latency(torch),
        },
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("imad_rate: no CUDA device", file=sys.stderr)
        return 1
    rec = {"device": torch.cuda.get_device_name(0), **measure(torch)}
    print(json.dumps(rec))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
