#!/usr/bin/env python3
"""Where the time goes in the PyTorch/CUDA port's prove, on one GPU.

    [MARLIN_TPU_CURVE=bn254] python3 tools/torch_prove_profile.py [--log2 14] [--out PATH]
    MARLIN_TPU_CURVE=test_wide750 python3 tools/torch_prove_profile.py --ahp [--log2 14] [--out PATH]

Builds the bench circuit (`DummyCircuit`, 2^log2 constraints, SRS sized by
`ahp.max_degree(n, n, 3n)`), runs setup and index, one warm-up prove, then:

* one prove with the phase spans of utils/profiling.py enabled (each span
  synchronizes the device, so a phase's seconds include its kernels);
* one prove under `torch.profiler` (CPU and CUDA activity): device time by
  kernel name, their sum, and the device's busy share of the wall time;
* the operand copies kernel 1's entry made in the spans' prove
  (`cuda.BINOP_COPIES`: broadcasts its row maps cannot express, and
  strided operands), and the entry's host microseconds a call at
  [4096, L] (1,000 calls, no synchronization);
* one more prove under `torch.profiler`, with the wrappers of the inversion
  and the NTT stage kernels noting each launch's shape: the device time of
  each of their launches in the prove, by kernel and shape (the profiler's
  kernel events matched to the launches in stream order);
* each kernel alone at the main path's largest shape (2^16 Fr elements;
  kernel 7 of the TPU package, `ops/mont.py::mont_mul`, at [4096, 16],
  and for the inversion also one Fr element, one Fq element and the table
  build's 25 x 2^16 Fq elements;
  2^16 points for the group law, and the bucket scans' 1,539; the prove's
  largest fold, round 3's three jobs of 2^16 - 1 scalars, for the bucket
  fold, and the classic route's [16384, 128] windows; 26 window sums at
  c = 10, the classic Pippenger's largest in that prove, for the window
  combine; the ladder of `scalar_mul_batch` at 2 and 512 points; the
  table route's shared ladder over c-bit digits for the prove's two
  one-point tails, its ladder launch and its join's adds), 20
  launches under the profiler (5 for the ladder): its device time per
  launch, free of the wrapper's host overhead that CUDA-event timing of a
  Python call includes.  A ladder that runs as many launches (the host
  loop of earlier versions) counts the device time of all of them.

With `MARLIN_TPU_MSM_TABLE=0` in the environment the proves take the
classic Pippenger instead of the fixed-base table.

With `--ahp` the run is the AHP alone, as chip_smoke.py drives it for a
field with no curve (test_wide750: no PC layer, no `Marlin`): the index
once, one warm run of the prover's and the verifier's rounds and the
linear combinations from that index (each step's seconds), one under
`torch.profiler` (device time by kernel, their sum and the busy share), one
with each inversion and NTT stage launch's device time by shape, and the
binop and the inversion alone at the AHP's sizes (and `mont_mul` at
[4096, L]).

The active curve (`MARLIN_TPU_CURVE`, default BLS12-381) sets the fields
and the group: the kernels' shapes above are element and point counts, and
where its Fr's 2-adicity is below 16 (synthetic_lowadic: 13) the NTT
kernels run the 2^16 elements as transforms of 2^(2-adicity) points.

Prints one JSON object (and writes it to `--out`).  Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _profiled_prove(torch, run) -> dict:
    """One prove (`run()`) under torch.profiler: device time by kernel and
    busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue  # CPU ops: their device time is their kernels', counted here
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and dev_us > 0:
            kernels.append({"name": ev.key[:120], "count": ev.count, "device_ms": dev_us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy_ms = sum(k["device_ms"] for k in kernels)
    return {
        "profiled_prove_s": wall,
        "device_busy_ms": busy_ms if kernels else None,
        "device_busy_share": busy_ms / (wall * 1e3) if kernels else None,
        "device_time_by_kernel": kernels[:40],
        # the port's own kernels (csrc/), whatever their rank
        "port_kernels": [k for k in kernels if "(anonymous namespace)::" in k["name"]],
    }


# kernel -> a substring of its symbol in the profiler's device events
_SHAPED = {"field_inv": "batch_inv_kernel", "ntt_block_stages": "block_stages_kernel",
           "ntt_cross_stage": "cross_stages_kernel"}


def _prove_launches_by_shape(torch, run) -> list:
    """Device ms of each launch of the inversion and NTT stage kernels in one
    prove (`run()`), by kernel and shape: the wrappers note each launch's
    shape in order, and the profiler's kernel events of each kernel, in
    stream order, give their device times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import ntt

    noted = {k: [] for k in _SHAPED}

    def noting(kernel, fn, shape_of):
        def wrapper(*args, **kwargs):
            noted[kernel].append(shape_of(*args, **kwargs))
            return fn(*args, **kwargs)
        return wrapper

    originals = (bi.inv_kernel, ntt.block_stages_kernel, ntt.cross_stages_kernel)
    bi.inv_kernel = noting("field_inv", bi.inv_kernel,
                           lambda ctx, x: f"{ctx.name} [{x.numel() // ctx.L}]")
    ntt.block_stages_kernel = noting(
        "ntt_block_stages", ntt.block_stages_kernel,
        lambda x, tw, log_b, log_n, scale=None:
            f"[{x.shape[0] >> log_n}, 2^{log_n}] {'inverse' if scale is not None else 'forward'}")
    ntt.cross_stages_kernel = noting("ntt_cross_stage", ntt.cross_stages_kernel,
                                     lambda x, tw, s0, s1: f"[{x.shape[0]}] stages {s0}-{s1 - 1}")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, contextlib.redirect_stdout(io.StringIO()):
            run()
            torch.cuda.synchronize()
    finally:
        bi.inv_kernel, ntt.block_stages_kernel, ntt.cross_stages_kernel = originals
    device = {k: [] for k in _SHAPED}
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue
        for k, sym in _SHAPED.items():
            if sym in ev.name:
                device[k].append((ev.time_range.end - ev.time_range.start) / 1e3)
    out = []
    for k in _SHAPED:
        if len(device[k]) != len(noted[k]):
            out.append({"kernel": k, "error": f"{len(noted[k])} launches, {len(device[k])} kernel events"})
            continue
        by_shape: dict = {}
        for shape, ms in zip(noted[k], device[k]):
            by_shape.setdefault(shape, []).append(ms)
        out.extend({"kernel": k, "shape": shape, "launches": len(v), "device_ms": v,
                    "device_ms_total": sum(v)} for shape, v in by_shape.items())
    return out


# kernel label -> substrings of its symbol in the profiler's device events
# (either template form the kernels have had: <FrTraits, 0> or <8, 0>; the
# binop's direct and staged bodies)
_FR_MUL = ("binop_kernel<FrTraits, 0>", "binop_staged_kernel<FrTraits, 0>", "binop_kernel<8, 0>")
_KERNEL_SYMBOLS = {
    "field_binop (fr mul)": _FR_MUL,
    # kernel 7 of the TPU package: an entry into kernel 1's Fr product
    "mont_mul ([4096, 16], kernel 7)": _FR_MUL,
    "field_inv (fr)": ("inv_kernel<FrTraits>", "inv_kernel<8>"),
    "field_inv (fr, 1 element)": ("inv_kernel<FrTraits>", "inv_kernel<8>"),
    "field_inv (fq, 1 element)": ("inv_kernel<FqTraits>", "inv_kernel<12>"),
    "field_inv (fq, 25 x 2^16)": ("inv_kernel<FqTraits>", "inv_kernel<12>"),
    "ntt_block_stages": ("block_stages_kernel",),
    "ntt_cross_stages (every stage past the block)": ("cross_stages_kernel", "cross_stage_kernel"),
    "g1_add (2^16 points)": ("::add_kernel",),
    "g1_add (1539 points, the scans)": ("::add_kernel",),
    "g1_double (2^16 points)": ("::double_kernel",),
    "bucket_fold (largest fold of the prove)": ("fold_kernel<false>",),
    "bucket_fold (classic [16384, 128])": ("fold_kernel<false>",),
    "combine_windows (c=10, W=26)": ("combine_kernel",),
    # the ladder: one scalar_mul launch, or the host loop's double and add
    "scalar_mul_batch (2 points)": ("scalar_mul_kernel", "::add_kernel", "::double_kernel"),
    "scalar_mul_batch (512 points)": ("scalar_mul_kernel", "::add_kernel", "::double_kernel"),
    # the table route's shared ladder over c-bit digits (the prove's two
    # one-point tails): one scalar_mul launch and the join's adds
    "shared ladder (2 one-point items, c=10)": ("scalar_mul_kernel", "::add_kernel"),
}


def _kernel_device_times(torch, reps: int = 20) -> dict:
    """Device microseconds per launch of each kernel at the main path's shapes."""
    import numpy as np

    from chip_smoke import FOLD_JOBS, fold_layout, random_elements
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import curve, fq, fr, mont, msm, ntt
    from marlin_tpu_torch.ops import curve_device as cd

    rng = np.random.default_rng(3)
    n = 1 << 16
    dev = torch.device("cuda")
    a = torch.as_tensor(random_elements(np, rng, fr.CTX, n), device=dev)
    b = torch.as_tensor(random_elements(np, rng, fr.CTX, n), device=dev)
    log_t = min(16, P.FR_TWO_ADICITY)  # the NTT kernels' transform size: 2^log_t points
    tw, _ = ntt._plan_tensors(1 << log_t, False, dev)
    x = a.clone()
    fq_table = torch.as_tensor(random_elements(np, rng, fq.CTX, 25 * n), device=dev)
    # the group law's cost does not depend on the operands being points
    p, q = ([torch.as_tensor(random_elements(np, rng, fq.CTX, n), device=dev) for _ in range(3)]
            for _ in range(2))
    # a table of random 32-bit limbs below q, at the 2^14 prove's c = 10
    half = fq.L // 2  # 32-bit words a coordinate
    top = fq.CTX.modulus >> (32 * (half - 1))
    xy = torch.randint(-(1 << 31), 1 << 31, (26 * n, fq.L), dtype=torch.int32, device=dev)
    xy[:, half - 1] &= (1 << (top.bit_length() - 1)) - 1
    xy[:, fq.L - 1] &= (1 << (top.bit_length() - 1)) - 1
    table = msm.FixedBaseTable(xy, 10, 26, n)
    layout = fold_layout(torch, table, FOLD_JOBS, 11)
    windows = tuple(torch.as_tensor(random_elements(np, rng, fq.CTX, 26), device=dev)[:, None]
                    for _ in range(3))
    # the classic route's largest fold: 16 windows x 1024 buckets, ~64 of 128 slots filled
    classic = torch.randint(-n, n + 1, (16384, 128), dtype=torch.int32, device=dev)
    classic[:, 64:] = 0
    xy_n = xy[:n].contiguous()
    scans = [tuple(c[:1539].contiguous() for c in pt) for pt in (p, q)]
    tails = [(1 << 14, fr.from_ints([3 ** 160 % fr.CTX.modulus], dev)),
             (1 << 14 | 1, fr.from_ints([5 ** 110 % fr.CTX.modulus], dev))]
    ladder = {}
    for m in (2, 512):
        sc = torch.as_tensor(random_elements(np, rng, fr.CTX, max(m, 4))[:m], device=dev)
        ladder[m] = (tuple(c[:m].contiguous() for c in p), bi.from_mont(fr.CTX, sc))
    calls = {
        "field_binop (fr mul)": lambda: bi.binop_kernel("mul", fr.CTX, a, b),
        "mont_mul ([4096, 16], kernel 7)": lambda: mont.mont_mul(a[:4096], b[:4096]),
        "field_inv (fr)": lambda: bi.inv_kernel(fr.CTX, a),
        "field_inv (fr, 1 element)": lambda: bi.inv_kernel(fr.CTX, a[5:6]),
        "field_inv (fq, 1 element)": lambda: bi.inv_kernel(fq.CTX, fq_table[5:6]),
        "field_inv (fq, 25 x 2^16)": lambda: bi.inv_kernel(fq.CTX, fq_table),
        "ntt_block_stages": lambda: ntt.block_stages_kernel(x, tw, ntt.BLOCK_LOG2, log_t),
        "ntt_cross_stages (every stage past the block)": lambda: [
            ntt.cross_stages_kernel(x, tw, s0, s1) for s0, s1 in ntt.cross_groups(log_t, ntt.BLOCK_LOG2)],
        "g1_add (2^16 points)": lambda: curve.add_kernel(p, q),
        "g1_add (1539 points, the scans)": lambda: curve.add_kernel(*scans),
        "g1_double (2^16 points)": lambda: curve.double_kernel(p),
        "bucket_fold (largest fold of the prove)": lambda: curve.bucket_fold_kernel(xy, layout),
        "bucket_fold (classic [16384, 128])": lambda: curve.bucket_fold_kernel(xy_n, classic),
        "combine_windows (c=10, W=26)": lambda: curve.combine_windows_kernel(windows, 10),
        "scalar_mul_batch (2 points)": lambda: cd.scalar_mul_batch(*ladder[2], P.FR_BITS),
        "scalar_mul_batch (512 points)": lambda: cd.scalar_mul_batch(*ladder[512], P.FR_BITS),
        "shared ladder (2 one-point items, c=10)": lambda: msm._shared_ladder(table, tails),
    }
    return _device_times(torch, calls, reps)


def _ahp_kernel_device_times(torch, K: int, reps: int = 20) -> dict:
    """Device microseconds per launch of the binop and the inversion at the
    AHP's |K| and 2^16 (the inversion also at one element), and of kernel 7
    of the TPU package (`ops/mont.py::mont_mul`) at [4096, L]."""
    import numpy as np

    from chip_smoke import random_elements
    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import fr, mont

    rng = np.random.default_rng(3)
    dev = torch.device("cuda")
    a, b = (torch.as_tensor(random_elements(np, rng, fr.CTX, 1 << 16), device=dev) for _ in range(2))
    calls = {}
    for label, n in ((f"|K| = {K}", K), ("2^16", 1 << 16)):
        calls[f"field_binop (fr mul, {label})"] = lambda n=n: bi.binop_kernel("mul", fr.CTX, a[:n], b[:n])
        calls[f"field_inv (fr, {label})"] = lambda n=n: bi.inv_kernel(fr.CTX, a[:n])
    calls["field_inv (fr, 1 element)"] = lambda: bi.inv_kernel(fr.CTX, a[5:6])
    calls[f"mont_mul ([4096, {fr.L}], kernel 7)"] = lambda: mont.mont_mul(a[:4096], b[:4096])
    symbols = {label: _KERNEL_SYMBOLS["field_inv (fr)" if "inv" in label else "field_binop (fr mul)"]
               for label in calls}
    return _device_times(torch, calls, reps, symbols)


def _binop_host_us(torch, calls: int = 1000) -> dict:
    """Host microseconds a call of kernel 1's entry (`bigint.binop_kernel`,
    Fr mul) at [4096, L]: `calls` calls with no synchronization between."""
    import numpy as np

    from chip_smoke import random_elements
    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import fr

    rng = np.random.default_rng(4)
    a, b = (torch.as_tensor(random_elements(np, rng, fr.CTX, 4096), device="cuda") for _ in range(2))
    for _ in range(10):
        bi.binop_kernel("mul", fr.CTX, a, b)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        bi.binop_kernel("mul", fr.CTX, a, b)
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return {"shape": f"[4096, {fr.L}]", "calls": calls, "host_us_per_call": us}


def _device_times(torch, calls: dict, reps: int, symbols: dict | None = None) -> dict:
    """Each call `reps` times (5 for a ladder) under the profiler -> its
    device microseconds and kernel launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    symbols = symbols or _KERNEL_SYMBOLS
    out = {}
    for label, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        calls_made = 5 if label.startswith("scalar_mul_batch") else reps
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls_made):
                fn()
            torch.cuda.synchronize()
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) == DeviceType.CUDA and any(
                    sym in ev.key for sym in symbols[label]):
                total_us += getattr(ev, "self_device_time_total", 0) or 0
                count += ev.count
        out[label] = {"device_us_per_call": total_us / calls_made,
                      "launches_per_call": count / calls_made}
    return out


def ahp_main(torch, log2: int) -> dict:
    """--ahp: the AHP alone (see the module's docstring)."""
    from chip_smoke import ahp_circuit, nvidia_smi_line, run_ahp
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import cuda
    from marlin_tpu_torch.snark.indexer import index_circuit

    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_line(),
           "curve": P.CURVE_NAME, "num_constraints": 1 << log2, "ahp": True}
    t = time.perf_counter()
    idx = index_circuit(ahp_circuit(log2)[1], "cuda")
    torch.cuda.synchronize()
    rec["index_s"] = time.perf_counter() - t
    rec["warm_run"] = run_ahp(torch, "cuda", log2, index=idx)
    cuda.reset_launches()
    rec["steps"] = run_ahp(torch, "cuda", log2, index=idx)
    rec["launches_per_run"] = dict(cuda.LAUNCHES)
    rec["binop_launches_per_run"] = {f"{f}.{k}": v for (f, k), v in cuda.BINOP_LAUNCHES.items()}
    rec["binop_copies_per_run"] = dict(cuda.BINOP_COPIES)
    rec["binop_entry"] = _binop_host_us(torch)
    rec["zero_evals"] = rec["steps"]["zero_evals"]
    try:
        rec.update(_profiled_prove(torch, lambda: run_ahp(torch, "cuda", log2, index=idx)))
        rec["run_launches_by_shape"] = _prove_launches_by_shape(
            torch, lambda: run_ahp(torch, "cuda", log2, index=idx))
        rec["kernel_device_times"] = _ahp_kernel_device_times(torch, idx.domain_k.size)
    except Exception as e:  # CUPTI tracing may be unavailable on the host
        rec["profiler_error"] = f"{type(e).__name__}: {e}"
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2", type=int, default=14)
    ap.add_argument("--ahp", action="store_true", help="the AHP alone (a field with no curve)")
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_prove_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.ahp:
        rec = ahp_main(torch, args.log2)
        print(json.dumps(rec))
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(rec, f, indent=1)
        return 0 if rec["zero_evals"] == {"inner_sumcheck": 0, "outer_sumcheck": 0} else 1

    from chip_smoke import DummyCircuit, nvidia_smi_line
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import cuda
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.utils import profiling
    from marlin_tpu_torch.utils.rand import test_rng

    n = 1 << args.log2
    rng = test_rng()
    a, b = rng.rand_fr(), rng.rand_fr()
    circ = DummyCircuit(a, b, num_variables=10, num_constraints=n)
    rec = {"device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_line(),
           "curve": P.CURVE_NAME, "num_constraints": n}

    t = time.perf_counter()
    srs = Marlin.universal_setup(n, n, 3 * n, rng, device="cuda")
    rec["setup_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pk, vk = Marlin.index(srs, circ, device="cuda")
    torch.cuda.synchronize()
    rec["index_s"] = time.perf_counter() - t

    t = time.perf_counter()
    proof = Marlin.prove(pk, circ, rng, device="cuda")
    torch.cuda.synchronize()
    rec["warm_prove_s"] = time.perf_counter() - t

    cuda.reset_launches()
    profiling.enable(True)
    profiling.collect()
    with contextlib.redirect_stdout(io.StringIO()):
        t = time.perf_counter()
        proof = Marlin.prove(pk, circ, rng, device="cuda")
        rec["spans_prove_s"] = time.perf_counter() - t
    rec["spans"] = profiling.collect()
    profiling.enable(False)
    rec["launches_per_prove"] = dict(cuda.LAUNCHES)
    rec["binop_launches_per_prove"] = {f"{f}.{k}": v for (f, k), v in cuda.BINOP_LAUNCHES.items()}
    rec["binop_copies_per_prove"] = dict(cuda.BINOP_COPIES)
    rec["binop_entry"] = _binop_host_us(torch)

    try:
        rec.update(_profiled_prove(torch, lambda: Marlin.prove(pk, circ, rng, device="cuda")))
        rec["prove_launches_by_shape"] = _prove_launches_by_shape(
            torch, lambda: Marlin.prove(pk, circ, rng, device="cuda"))
        rec["kernel_device_times_2_16"] = _kernel_device_times(torch)
    except Exception as e:  # CUPTI tracing may be unavailable on the host
        rec["profiler_error"] = f"{type(e).__name__}: {e}"

    public = [a * b % P.R_MODULUS]
    rec["verifies"] = bool(Marlin.verify(vk, public, proof, rng, device="cuda"))
    rec["proof_bytes"] = proof.serialized_size()
    text = json.dumps(rec)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0 if rec["verifies"] else 1


if __name__ == "__main__":
    sys.exit(main())
