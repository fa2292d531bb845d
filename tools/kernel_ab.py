#!/usr/bin/env python3
"""Kernel 1 (the field binop) and kernel 3(b) (the NTT stages past the
block) of one tree of the port, timed at the main path's shapes: for
comparing two trees on one card in one call.

    [MARLIN_TPU_CURVE=test_wide750] python3 tools/kernel_ab.py --root DIR [--out PATH]

Imports `marlin_tpu_torch` from DIR (this repository, or an unpacked
earlier commit of it), builds its kernels there, and measures:

* kernel 1's entry, `bigint.binop_kernel` (Fr mul at [4096, L], kernel 7's
  shape): host microseconds a call over 1,000 calls with no
  synchronization;
* kernel 1 at Fr mul 2^14, 2^16 and [4096, L], Fq mul 2^14 and 2^16 (no
  Fq under test_wide750; its |K| = 55,296 instead), and Fr mul with a
  [1, L] operand at 2^16: card ms (CUDA events around a Python call,
  median of 20) and device ms (every kernel the call launches, under
  torch.profiler, median of 20 calls), the latter including the copy an
  earlier tree makes of a broadcast operand; and, in a tree whose kernel 1
  has two bodies, Fr and Fq mul at 2^16 on each (`staged=`);
* kernel 3(b), every stage past the 2^10 block of a transform, at 2^14,
  2^16, a batch of two 2^16 and 2^18 (its stages split over two groups)
  (at 24 words: 2^13, and 55,296 as 27 inner transforms of 2^11): card
  ms and device ms of all its launches, and their count.

Works on a tree whose 3(b) runs one stage a launch (`cross_stage_kernel`)
or a group a launch (`cross_stages_kernel`).  Prints one JSON object with
the card's name and power limit; needs a CUDA device; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def _card_ms(torch, fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(torch, fn, reps: int = 20) -> tuple:
    """(median device ms of one call's kernels, kernels a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    per_call = []
    launches = 0
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events() if getattr(ev, "device_type", None) == DeviceType.CUDA]
        per_call.append(sum(ev.time_range.end - ev.time_range.start for ev in evs) / 1e3)
        launches = len(evs)
    return statistics.median(per_call), launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the tree whose marlin_tpu_torch is measured")
    ap.add_argument("--out")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import cuda, fr, ntt

    assert os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(bi.__file__)))) == root, bi.__file__
    t = time.perf_counter()
    cuda.lib()
    rec = {"root": root, "curve": P.CURVE_NAME, "device": torch.cuda.get_device_name(0), "nvidia_smi": _smi(),
           "build_s": time.perf_counter() - t, "grouped_3b": hasattr(ntt, "cross_stages_kernel")}
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)

    def elements(ctx, n):
        top = int(np.flatnonzero(ctx.n_limbs)[-1])
        x = rng.integers(0, 1 << 16, size=(n, ctx.L), dtype=np.int64)
        x[:, top] = rng.integers(0, int(ctx.n_limbs[top]), size=n)
        x[:, top + 1:] = 0
        return torch.as_tensor(x.astype(np.int32), device=dev)

    wide = P.CURVE_NAME == "test_wide750"
    fields = [("fr", fr.CTX)]
    if not wide:
        from marlin_tpu_torch.ops import fq

        fields.append(("fq", fq.CTX))
    a, b = elements(fr.CTX, 4096), elements(fr.CTX, 4096)
    for _ in range(10):
        bi.binop_kernel("mul", fr.CTX, a, b)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(1000):
        bi.binop_kernel("mul", fr.CTX, a, b)
    rec["binop_host_us_per_call"] = (time.perf_counter() - t) / 1000 * 1e6
    torch.cuda.synchronize()

    binop = {}
    cases = [("fr", fr.CTX, 4096)]
    for name, ctx in fields:
        cases += [(name, ctx, 1 << 14), (name, ctx, 1 << 16)]
    if wide:
        cases.append(("fr", fr.CTX, 55296))
    for name, ctx, n in cases:
        x, y = elements(ctx, n), elements(ctx, n)
        fn = (lambda ctx=ctx, x=x, y=y: bi.binop_kernel("mul", ctx, x, y))
        dms, k = _device_ms(torch, fn)
        binop[f"{name} mul [{n}]"] = {"card_ms": _card_ms(torch, fn), "device_ms": dms, "kernels": k}
    if "staged" in inspect.signature(bi.binop_kernel).parameters:  # both bodies of a tree that has two
        for name, ctx in fields:
            x, y = elements(ctx, 1 << 16), elements(ctx, 1 << 16)
            for staged in (False, True):
                fn = (lambda ctx=ctx, x=x, y=y, staged=staged: bi.binop_kernel("mul", ctx, x, y, staged=staged))
                dms, k = _device_ms(torch, fn)
                binop[f"{name} mul [{1 << 16}] {'staged' if staged else 'direct'}"] = {
                    "card_ms": _card_ms(torch, fn), "device_ms": dms, "kernels": k}
    x, s = elements(fr.CTX, 1 << 16), elements(fr.CTX, 1)
    fn = (lambda: bi.binop_kernel("mul", fr.CTX, x, s))
    dms, k = _device_ms(torch, fn)
    binop[f"fr mul [{1 << 16}] by [1, L]"] = {"card_ms": _card_ms(torch, fn), "device_ms": dms, "kernels": k}
    rec["binop"] = binop

    cross = {}
    shapes = [(1 << 13, 1), (55296, 27)] if wide else [(1 << 14, 1), (1 << 16, 1), (1 << 17, 2), (1 << 18, 1)]
    for total, batch in shapes:
        n = total // batch
        if n & (n - 1):
            _, n2, tw, _, _, _ = ntt._mixed_tensors(n, False, dev)
            log_n = n2.bit_length() - 1
        else:
            tw, _ = ntt._plan_tensors(n, False, dev)
            log_n = n.bit_length() - 1
        v = elements(fr.CTX, total)
        if rec["grouped_3b"]:
            groups = ntt.cross_groups(log_n, ntt.BLOCK_LOG2)
            fn = (lambda v=v, tw=tw, groups=groups: [ntt.cross_stages_kernel(v, tw, s0, s1) for s0, s1 in groups])
        else:
            fn = (lambda v=v, tw=tw, log_n=log_n: [ntt.cross_stage_kernel(v, tw, s)
                                                   for s in range(ntt.BLOCK_LOG2, log_n)])
        dms, k = _device_ms(torch, fn)
        cross[f"[{batch}, {n}]"] = {"stages": log_n - ntt.BLOCK_LOG2, "card_ms": _card_ms(torch, fn),
                                    "device_ms": dms, "launches": k}
    rec["cross"] = cross
    text = json.dumps(rec)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
