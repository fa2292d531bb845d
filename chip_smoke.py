#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (marlin_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out PATH]

Phases, each printing one line of JSON:

1. device  — the card's name, count and `nvidia-smi` name/power limit;
2. build   — compile the CUDA kernels (marlin_tpu_torch/csrc) from source;
3. kernels — every kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes, with edge inputs (0, 1, N-1;
   identity points, P + P, P + (-P); the fold at the table and the classic
   shape, each with its own sub-row count, fast and exact, and a lane that
   meets P == Q; the ladder at the prove's 2 points and at 512, with
   identity points and scalars 0, 1 and r - 1, and the table route's
   shared ladder over c-bit digits at the prove's shape (round 1's two
   one-point tails, c = 10, W = 26) against its plain run and the host
   MSM; identity window sums, and 128 of them; the batch inversion at
   Fr 2^16, 2^14 and one element and
   at the table build's 25 x 2^16 Fq, zeros at a thread's and a block's
   edges; the NTT at each of the prove's transform shapes, whole
   transforms and each stage kernel, forward and inverse, 3(b) over its
   groups of stages and at a shape split over two; the field binop at 2^14
   and 2^16 for Fr and Fq with full, [1, L] and [len, L] operands, both of
   its bodies at 2^16, and its entry's host microseconds a call); each
   timed with CUDA events beside its plain version, and its device time in
   one torch.profiler session (`device_times`);
4. small   — a one-constraint circuit (SRS 32/32/96) proved under
   `test_rng()` on the CPU (plain versions) and on the card: equal proof
   bytes, the card's proof verifies, a wrong input and a flipped byte are
   rejected;
5. medium  — `DummyCircuit` at 2^11 constraints (an SRS of 8192 powers, so
   every commit takes the card's table MSM) proved on the CPU and on the
   card: equal proof bytes, and the bucket fold launched;
6. main    — the 2^14-constraint MarlinKZG10 prove over BLS12-381
   (`DummyCircuit`, SRS sized by `ahp.max_degree(n, n, 3n)`): setup, index,
   prove, verify, with phase and round seconds and each kernel's launch
   count, all of which but the window combine's must be above 0; the proof
   must verify and be 855 B; the prove reruns no MSM, calls no host MSM,
   runs its ladder in one scalar_mul launch and no doubling launch, each
   inversion in one launch, and each NTT in one block-stage launch plus one
   per group of stages above 2^10 (at most 11 such launches), with no
   gather op and no Fr product of its own, and copies no broadcast operand
   of the field binop;
7. classic — the same prove from the same rng state with
   `MARLIN_TPU_MSM_TABLE=0`, every MSM on the classic Pippenger: equal
   proof bytes, the window combine launched once per MSM job, no host MSM
   call, no rerun; then steady proves on both routes in turns (table,
   classic, classic, table), each from that rng state and with those bytes;
8. msm     — the 2^14 prove's own MSM job list (offsets and sizes) with
   seeded random scalars through the card's commit path, each result equal
   to the native host MSM; the public `msm()` on the card (random scalars,
   duplicate points whose fast fold flags and reruns exactly, an identity
   and a point off affine form, a ladder-sized batch) against the host
   MSM; then a job of one repeated scalar, whose flag must fire and whose
   exact classic rerun must equal the host MSM;
9. sonic   — `MarlinSonic` on `DummyCircuit` at 2^11 on the CPU and on the
   card (equal proof bytes), then at 2^14 on the card: the proof verifies
   at 759 B, with no host MSM call;
10. serial — the main path's SRS, prover key (with its SRS and without) and
   verifier key saved (snark/serial.py) and loaded on the card, with the
   seconds of each beside main's setup and index: the load's power check
   launches kernel 1's Fq products and add, and is timed against the JAX
   package's host-int check of the same powers; the loaded keys prove
   main's bytes, which the loaded verifier key accepts; a limb >= 2^16, a
   non-affine Z, a residue >= q, an off-curve power, a flipped G2
   coordinate and a commitment off the curve each raise ValueError; then
   the loaded lean key proves main's bytes with the table's window width
   at MARLIN_TPU_FIXED_C = 12 and at its default (10), a first and a
   steady prove each, with the table's MB and the commit spans of each;
11. sharded — the 2^14 prove under a mesh of four shards (`mesh=`: four
   cards where the machine has them, else the one card four times) with
   main's bytes, launching kernels 1, 2, 3(a), 4, 5 and 6 at shard shapes
   (no 3(b): the four-step's row and column transforms fit in one block of
   3(a)) and no host MSM; one steady single-device and one steady sharded
   prove; a 2^16 four-step NTT (both variants, forward and inverse) and the
   three MSM bodies (point shards at 2^16 over 4, window blocks at 2^12
   over 4, the ladder at 2^12 over 8) equal to the single-device results;
12. distributed — the same over a mesh spanning two processes
   (`--dist-rank`, `multihost.init_distributed` on a file store): dcn = 2
   ranks x ici = 2 shards, each rank on cards 2r and 2r+1 where the
   machine has four, on card r twice where it has two or three (NCCL),
   and both on card 0 twice where it has one (gloo, through host
   memory); each rank loads phase serial's archives and proves from
   main's rng state with main's bytes (which main's verifier key
   accepts), launching every kernel of phase sharded and no host MSM, a
   first and a steady prove; the 2^16 four-step NTTs and the three MSM
   bodies across the ranks equal each rank's single-device results; the
   backend, the exchanges' count and bytes, and the phase's seconds;
13. bn254, synthetic_lowadic, bls12_377 — each curve in a process of its
   own (`--curve`, with `MARLIN_TPU_CURVE` set; the build phase compiled its
   library beside BLS12-381's): its main path on the card (`DummyCircuit`
   at 2^14, at 2^11 for BLS12-377: setup with the G1
   powers by kernel 4's ladder, index, prove, verify, a wrong input and a
   flipped byte rejected, no host MSM, every NTT in its kernels, on
   synthetic_lowadic's mixed-radix domains |H| = 18,432 and |K| = 55,296
   with the inner transforms through kernel 3 and none on the host), the
   classic route's proof equal to the table route's; its kernel rows at its
   main path's shapes against their plain versions (and, for
   synthetic_lowadic, the mixed transforms at n1 = 3, 9 and 27); its card
   proof equal to a CPU proof made beside the earlier phases (`--cpu-proof`:
   BN254 at 2^10, synthetic_lowadic at 2^11 under
   MARLIN_TPU_FR_TWO_ADICITY_CAP = 10, so both domains are mixed, and
   BLS12-377's main proof at 2^11); and for BN254 a MarlinSonic prove at
   2^11; and its SRS, lean prover key and verifier key round-tripped as in
   phase serial (no full key, no tamper cases);
14. test_wide750 — a 750-bit field with no curve (24-word Fr, no Fq, no
   G1), in a process of its own like the curves above (its library holds
   the field and NTT kernels only, and refuses an Fq call): its AHP at
   2^14 on the card as tests/test_wide750.py drives it (`run_ahp`: index,
   prover_init, the three rounds with the verifier's between them, the
   query set and the linear combinations) on mixed-radix domains
   |H| = 18,432 and |K| = 55,296, both sumcheck combinations 0, every
   mixed transform on the card in its kernels and each of kernels 1, 2, 3a
   and 3b launched; its kernel rows at 24 words (the binop at |K| and
   2^16, the inversion at the AHP's sizes and one element, the transforms
   at the AHP's shapes, at 81·2^9 and at 2^13, 3(a) with blocks of 2^9 and
   2^10); and the card's AHP at 2^6 under MARLIN_TPU_FR_TWO_ADICITY_CAP = 5
   (|H| = 72, |K| = 216) against a CPU run made beside the earlier phases:
   the same challenges and the same limbs in every oracle.

The build phase also records the curve, chain, inversion and NTT block
kernels' registers, stack frame and spills (`ptxas -v`, which must show no
spill for a kernel the path runs), the SASS counts of each kernel and the
integer multiplies of one Fq and one Fr product (tools/sass_count.py), and
measures the card's multiply rate and the latency of one dependent product
and of one doubling step (tools/imad_rate.py): the operation bounds divide
by the card's peak multiply rate in the same unit, beside which the
measured rate is recorded as the share reached, and the ladder's and the
combine's chain floors multiply their dependent levels by that latency.  Then the kernel table, the card's
name and power limit, and, as the last line, `{"ok": true, "device": {...}}`.
The kernel table holds BLS12-381's rows and, named `<curve>:<kernel>`,
each other curve's and test_wide750's.  Any failure
exits nonzero before that line.  Needs one CUDA device and the repository beside this script;
imports nothing of JAX.  `--out` also writes every phase's record to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peaks used for bounds.  HBM bandwidth: 3.35 TB/s (NVIDIA's H100 SXM data
# sheet).  Operations: the kernels' work is the Montgomery product's carry
# chains of 32-bit integer multiply-adds.  The CUDA C++ Programming Guide
# (table "Throughput of Native Arithmetic Instructions", compute capability
# 9.0) gives 64 extended-precision multiply-adds a clock an SM, counting
# PTX's mad.lo.cc and madc.hi.cc apart; ptxas fuses each such pair into one
# IMAD.WIDE.U32, the unit in which this build's SASS counts the multiplies
# of one product.  So the peak is 32 IMAD.WIDE a clock an SM, times the SMs
# and the maximum SM clock.  The rate reached with every SM busy is measured
# in the build phase (tools/imad_rate.py) and recorded beside it.
PEAK_BYTES_PER_S = 3.35e12
IMAD_PER_CLOCK_PER_SM = 64
PEAK_OPS_PER_S = None
MULS_PER_PRODUCT: dict = {}  # "fr" / "fq" -> integer multiplies in one Montgomery product
# the latency of one dependent Fq product on one thread, microseconds (measured)
FQ_PRODUCT_US = None
# dependent product levels of one step of the chain kernels (csrc/chain.cu)
DOUBLING_LEVELS, ADD_LEVELS = 3, 5

# the main path's shapes: |H| = 2^14 constraints, |K| = the mul domain = 2^16
MAIN_LOG2 = 14
FR_N = 1 << 16
FQ_N = 1 << 14
MONT_N = 4096
# kernel 2: |K|, |H| and one opening point's z^-1; then the table build's one
# Fq normalization, W - 1 = 25 blocks of the 65,536-power SRS
INV_SHAPES = (("fr", 1 << 16), ("fr", 1 << 14), ("fr", 1), ("fq", 25 << 16))
# kernel 3: the 2^14 prove's transform shapes (|H| and its batches of 2 and
# 3; |K| = 2^16 alone and in batches of 2 and 4; 2^17 in a batch of 2)
NTT_PROVE_SHAPES = ((1 << 14,), (2, 1 << 14), (3, 1 << 14), (1 << 16,), (2, 1 << 16), (4, 1 << 16),
                    (2, 1 << 17))
# kernel 4 at the table build's width; kernel 5 at the 2^14 prove's largest
# fold: round 3's three jobs of 2^16 - 1 scalars (offsets 0, 1, 0)
CURVE_N = 1 << 16
SCAN_N = 3 * 513  # the Hillis scans' points: round 3's 3 jobs x 513 buckets
LADDER_N, LADDER_WIDE_N = 2, 512  # the ladder at round 1's two tails over 255 bits, and wider
MAIN_HEAD = 1 << MAIN_LOG2  # round 1's jobs hold 2^14 + 1 points: a one-point tail past 2^14
FOLD_JOBS = ((0, (1 << 16) - 1), (1, (1 << 16) - 1), (0, (1 << 16) - 1))
MEDIUM_LOG2 = 11
REPEATED_N = 1 << 14  # points of the msm phase's repeated-scalar job
# kernel 6 at the 2^14 prove's largest classic MSMs (65,534-65,535 points)
COMBINE_C, COMBINE_W = 10, 26
DEV = "cuda"
# the runs' files: the archives, the CPU reference proofs, the ranks' store and records
SMOKE_DIR = os.path.join(ROOT, "marlin_tpu_torch", "build", "smoke")

RECORDS: list = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


class SmokeFailure(Exception):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call, by CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_times(torch, calls: dict, reps: int = 20) -> dict:
    """Device milliseconds of each call's kernels, free of the wrapper's host
    time: each call `reps` times in a torch.profiler session of its own,
    the median over its kernel events of its symbol (the events of a call
    of several launches summed in stream order).  calls: label -> (fn,
    symbol fragment, kernels of that symbol one call launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, (fn, sym, count) in calls.items():
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a session now and then reports no kernel event: run it again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            evs = sorted((ev for ev in prof.events() if getattr(ev, "device_type", None) == DeviceType.CUDA
                          and sym in ev.name), key=lambda ev: ev.time_range.start)
            if len(evs) >= count:
                break
        ms = [(ev.time_range.end - ev.time_range.start) / 1e3 for ev in evs]
        require(len(ms) >= count, f"device_times: {label}: {len(ms)} kernel events of {sym} in three sessions")
        per_call = [sum(ms[i : i + count]) for i in range(0, len(ms) - count + 1, count)]
        out[label] = statistics.median(per_call)
    return out


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def product_ops(field: str, products: float) -> float:
    """Integer multiplies of `products` Montgomery products over Fr or Fq."""
    return products * MULS_PER_PRODUCT[field]


def integer_peak(torch) -> dict:
    """The peak rate of fused IMAD.WIDE multiplies: IMAD_PER_CLOCK_PER_SM / 2
    a clock on each SM at its maximum SM clock (nvidia-smi clocks.max.sm)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    wide = IMAD_PER_CLOCK_PER_SM / 2
    return {"sms": sms, "max_sm_clock_mhz": mhz, "ptx_multiply_adds_per_clock_per_sm": IMAD_PER_CLOCK_PER_SM,
            "imad_wide_per_clock_per_sm": wide, "ops_per_s": wide * sms * mhz * 1e6}


def ptxas_report(path: str) -> dict:
    """`ptxas -v` of one source -> kernel symbol -> registers, stack frame
    and spill bytes."""
    import re

    out, name = {}, None
    for line in open(path):
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


# each kernel's ptxas report: source, symbol fragment.  A kernel the main
# path runs must show no spill.
PTXAS_KERNELS = {
    "g1_add": ("curve.cu", "add_kernel"), "g1_double": ("curve.cu", "double_kernel"),
    "bucket_fold": ("curve.cu", "fold_kernelILb0E"), "bucket_fold_exact": ("curve.cu", "fold_kernelILb1E"),
    "g1_scalar_mul": ("chain.cu", "scalar_mul_kernel"), "combine_windows": ("chain.cu", "combine_kernel"),
    "field_binop_fr": ("field.cu", "binop_kernelI8FrTraitsLi0E"),
    "field_binop_staged_fr": ("field.cu", "binop_staged_kernelI8FrTraitsLi0E"),
    "field_binop_fq": ("field.cu", "binop_kernelI8FqTraitsLi0E"),
    "field_binop_staged_fq": ("field.cu", "binop_staged_kernelI8FqTraitsLi0E"),
    "field_inv_fr": ("field.cu", "batch_inv_kernelI8FrTraitsE"),
    "field_inv_fq": ("field.cu", "batch_inv_kernelI8FqTraitsE"),
    "ntt_block_stages": ("ntt.cu", "block_stages_kernel"),
    "ntt_cross_stage": ("ntt.cu", "cross_stages_kernel"),
    "imad_rate": ("imad.cu", "imad_rate_kernelILi8E"),
}


def ptxas_kernels(curve: str) -> dict:
    """The PTXAS_KERNELS that `curve`'s library holds: those of its sources,
    and no Fq kernel for a field with no curve."""
    from marlin_tpu_torch.ops import cuda

    srcs = cuda.sources(curve)
    return {label: (src, frag) for label, (src, frag) in PTXAS_KERNELS.items()
            if src in srcs and not (curve in cuda.FIELD_ONLY and label.endswith("_fq"))}


def phase_build(torch) -> dict:
    """Build the kernels; record each kernel's registers and spills, its SASS
    counts and the multiplies of one product; measure the multiply rate and
    the chain latencies."""
    global PEAK_OPS_PER_S, FQ_PRODUCT_US
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import imad_rate
    import sass_count

    from marlin_tpu_torch.ops import cuda, curve

    # every curve's library in one parallel round of nvcc (the other curves'
    # processes then find theirs built)
    secs = cuda.build(list(cuda.CURVE_IDS))
    cuda.lib()
    ptxas, ptxas_curves = {}, {}
    for name in cuda.CURVE_IDS:
        reports = {src: ptxas_report(os.path.join(cuda.build_dir(name), src + ".ptxas.txt"))
                   for src in cuda.sources(name)}
        rec = {}
        for label, (src, frag) in ptxas_kernels(name).items():
            hits = [v for k, v in reports[src].items() if frag in k and "registers" in v]
            require(len(hits) == 1, f"ptxas: {len(hits)} reports for {label} ({name})")
            rec[label] = hits[0]
            require(hits[0].get("spill_stores", 0) == 0 and hits[0].get("spill_loads", 0) == 0,
                    f"ptxas: {label} spills ({name}): {hits[0]}")
        ptxas_curves[name] = rec
    ptxas = ptxas_curves[cuda.active_curve()]
    sass = sass_count.count(cuda.lib_path())
    for field in ("fr", "fq"):
        MULS_PER_PRODUCT[field] = sass["product"][field]["multiplies"]
    peak = integer_peak(torch)
    measured = imad_rate.measure(torch)
    PEAK_OPS_PER_S = peak["ops_per_s"]
    FQ_PRODUCT_US = measured["latency"]["fq_product"]["us_per_product"]
    return {"seconds": secs, "curves": list(cuda.CURVE_IDS), "ptxas": ptxas,
            "ptxas_by_curve": {c: {k: v.get("registers") for k, v in r.items()}
                               for c, r in ptxas_curves.items()},
            "runtime": curve.kernel_info(),
            "kernel_sass": sass["kernels"],
            "product_sass": {f: {k: v for k, v in r.items() if k != "binop_mul_kernel"}
                             for f, r in sass["product"].items()},
            "integer_peak": peak, "imad": measured, "ops_per_s_used": PEAK_OPS_PER_S,
            "imad_share_of_peak": measured["rate"]["multiplies_per_s"] / PEAK_OPS_PER_S}


def chain_floor_ms(levels: float) -> float:
    """Dependent product levels times one dependent Fq product's latency."""
    return levels * FQ_PRODUCT_US / 1e3


FQ_BYTES = 96  # one Fq element in the int32 limb layout (24 words; `set_curve_shapes`)
FR_BYTES = 64  # one Fr element in the int32 limb layout (16 words; 48 for test_wide750)


# --------------------------------------------------------------------------


def random_elements(np, rng, ctx, n: int):
    """[n, L] canonical limbs (< N) with the edge values 0, 1, N-1, N-2 first."""
    from marlin_tpu_torch.ops.limbs import int_to_limbs

    L = ctx.L
    top = int(np.flatnonzero(ctx.n_limbs)[-1])  # N's top nonzero limb (46 of test_wide750's 48)
    x = rng.integers(0, 1 << 16, size=(n, L), dtype=np.int64)
    x[:, top] = rng.integers(0, int(ctx.n_limbs[top]), size=n)  # below N's
    x[:, top + 1:] = 0
    for i, v in enumerate((0, 1, ctx.modulus - 1, ctx.modulus - 2)):
        x[i] = int_to_limbs(v, L)
    return x.astype(np.int32)


def phase_kernels(torch, np) -> dict:
    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import cuda, fq, fr, mont

    rng = np.random.default_rng(1)
    dev = torch.device(DEV)
    results = {}

    def err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    # kernel 1: Fr and Fq at 2^14 and 2^16 (and |K|), full and broadcast operands
    results["field_binop"] = binop_rows(torch, np, rng, err, (fr.CTX, fq.CTX), sorted({1 << 14, 1 << 16, FR_N}))

    results["field_inv"] = inversion_row(torch, np, rng, err)
    results.update(ntt_rows(torch, np, rng, err))

    # kernel 7 of the TPU package: mont_mul on [4096, 16] (an entry into kernel 1)
    ma = torch.as_tensor(random_elements(np, rng, fr.CTX, MONT_N), device=dev)
    mb = torch.as_tensor(random_elements(np, rng, fr.CTX, MONT_N), device=dev)
    b_ms, b_by = bound(3 * MONT_N * 64, product_ops("fr", MONT_N))
    results["mont_mul"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/field.cu",
        "replaces": "marlin_tpu/ops/pallas/mont.py:83",
        "max_abs_err": err(mont.mont_mul(ma, mb), bi.mont_mul(fr.CTX, ma, mb)),
        "shape": f"[{MONT_N}, 16]",
        "ms": time_ms(torch, lambda: mont.mont_mul(ma, mb)),
        "device_ms": device_times(torch, {"mont_mul": (lambda: mont.mont_mul(ma, mb), "binop_", 1)})["mont_mul"],
        "plain_ms": time_ms(torch, lambda: bi.mont_mul(fr.CTX, ma, mb), reps=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    torch.cuda.synchronize()
    for name, r in results.items():
        require(r["max_abs_err"] == 0, f"{name} disagrees with its plain version: {r}")
    results.update(phase_curve_kernels(torch, np))
    cuda.reset_launches()
    return results


# kernel 1's broadcast operand [len, L] against [BCAST_M, len, L] (as
# poly.evaluate_batch's powers against its polynomials)
BCAST_M = 4
HOST_US_N, HOST_US_CALLS = 4096, 1000


def binop_rows(torch, np, rng, err, ctxs, sizes) -> dict:
    """Kernel 1 against its plain version for each field of `ctxs` at each
    of `sizes`: mul / add / sub on full operands, mul with one operand below
    R (to_mont of raw limbs), and mul with a [1, L] and a [len, L] operand
    read in place (no copy: cuda.BINOP_COPIES stays 0), each with its card
    ms, device ms, bound (each operand row read once) and the share of it
    reached; then both bodies (direct, staged) at the largest size (2^16)
    for each width, and
    the entry's host microseconds a call at [4096, L] (HOST_US_CALLS calls,
    no synchronization).  -> the kernel row (Fr mul at 2^16 its head)."""
    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import cuda

    dev = torch.device(DEV)
    checks, calls, head = [], {}, None
    for ctx in ctxs:
        nb = 4 * ctx.L
        for n in sizes:
            a = torch.as_tensor(random_elements(np, rng, ctx, n), device=dev)
            b = torch.as_tensor(random_elements(np, rng, ctx, n), device=dev).flip(0).contiguous()
            raw = torch.as_tensor(rng.integers(0, 1 << 16, size=(n, ctx.L), dtype=np.int64).astype(np.int32),
                                  device=dev)
            one = torch.as_tensor(random_elements(np, rng, ctx, 5)[2:3], device=dev)  # [1, L]: N - 1
            length = n // BCAST_M
            row = torch.as_tensor(random_elements(np, rng, ctx, length), device=dev)
            cases = [("mul", "full", a, b, 2 * n), ("add", "full", a, b, 2 * n), ("sub", "full", a, b, 2 * n),
                     ("mul", "a < R", raw, b, 2 * n), ("mul", "[1, L]", a, one, n + 1),
                     ("sub", "[1, L]", one, a, n + 1),
                     ("mul", "[len, L]", a.reshape(BCAST_M, length, ctx.L), row, n + length)]
            for op, operand, x, y, rows_read in cases:
                before = dict(cuda.BINOP_COPIES)
                got = bi.binop_kernel(op, ctx, x, y)
                copies = sum(cuda.BINOP_COPIES[k] - before[k] for k in before)
                require(copies == 0, f"kernel 1 copied an operand of {ctx.name} {op} {operand} [{n}]")
                b_ms, b_by = bound((rows_read + n) * nb, product_ops(ctx.name, n) if op == "mul" else 0)
                label = f"{ctx.name} {op} {operand} [{n}]"
                fn = (lambda op=op, ctx=ctx, x=x, y=y: bi.binop_kernel(op, ctx, x, y))
                calls[label] = (fn, "binop_", 1)
                checks.append({"label": label, "field": ctx.name, "op": op, "operand": operand, "n": n,
                               "max_abs_err": err(got, bi.PLAIN_OPS[op](ctx, x, y)), "ms": time_ms(torch, fn),
                               "bound_ms": b_ms, "bound_by": b_by})
                if (ctx.name, op, operand, n) == ("fr", "mul", "full", max(sizes)):
                    head = checks[-1]
                    head["plain_ms"] = time_ms(torch, lambda: bi.mont_mul(ctx, x, y), reps=5)
            if n == max(sizes):  # both bodies, at 2^16
                for staged in (False, True):
                    calls[f"{ctx.name} mul full [{n}] {'staged' if staged else 'direct'}"] = (
                        lambda ctx=ctx, a=a, b=b, staged=staged: bi.binop_kernel("mul", ctx, a, b, staged=staged),
                        "binop_", 1)
                    e = err(bi.binop_kernel("mul", ctx, a, b, staged=staged), bi.mont_mul(ctx, a, b))
                    require(e == 0, f"kernel 1's {'staged' if staged else 'direct'} body disagrees ({ctx.name})")
    device = device_times(torch, calls)
    for c in checks:
        c["device_ms"] = device[c["label"]]
        c["reached"] = c["bound_ms"] / c["device_ms"]
    variants = {label: ms for label, ms in device.items() if label.endswith(("staged", "direct"))}
    # the entry's host time a call, at kernel 7's shape
    ctx = ctxs[0]
    ha = torch.as_tensor(random_elements(np, rng, ctx, HOST_US_N), device=dev)
    hb = torch.as_tensor(random_elements(np, rng, ctx, HOST_US_N), device=dev)
    for _ in range(10):
        bi.binop_kernel("mul", ctx, ha, hb)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(HOST_US_CALLS):
        bi.binop_kernel("mul", ctx, ha, hb)
    host_us = (time.perf_counter() - t) / HOST_US_CALLS * 1e6
    torch.cuda.synchronize()
    return {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/field.cu",
        "replaces": "marlin_tpu/ops/pallas/field.py:101",
        "max_abs_err": max(c["max_abs_err"] for c in checks), "checks": checks, "variants": variants,
        "staged_words": sorted(bi.BINOP_STAGED_WORDS), "host_us_per_call": host_us,
        "host_us_shape": f"[{HOST_US_N}, {ctx.L}]", "shape": f"fr mul [{max(sizes)}, {ctx.L}]", "ms": head["ms"],
        "device_ms": head["device_ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
    }


def inversion_row(torch, np, rng, err) -> dict:
    """Kernel 2 at the prove's sizes (|K|, |H|, one opening point) and at the
    table build's Fq normalization, zeros at the edges of a thread's run and
    of a block; each against the plain batch inversion, with x * x^-1 = 1."""
    import importlib

    from marlin_tpu_torch.ops import bigint as bi

    dev = torch.device(DEV)
    shapes = []
    for field, n in INV_SHAPES:
        ctx = importlib.import_module(f"marlin_tpu_torch.ops.{field}").CTX  # no Fq under test_wide750
        # the edge values 0, 1, N-1, N-2 first; one random element for n = 1
        x = torch.as_tensor(random_elements(np, rng, ctx, max(n, 5))[-n:], device=dev).contiguous()
        if n > 256:
            x[torch.as_tensor([0, 127, 128, 255, n - 1], device=dev)] = 0
        got = bi.inv_kernel(ctx, x)
        e = err(got, bi.inv_mod(ctx, x))
        zero = (x == 0).all(-1)
        require(bool((got[zero] == 0).all()), f"inv(0) != 0 ({field}, {n})")
        one = torch.as_tensor(ctx.one_limbs.astype(np.int32), device=dev)
        require(bool((bi.binop_kernel("mul", ctx, x, got)[~zero] == one).all()), f"x * inv(x) != 1 ({field}, {n})")
        nbytes = 2 * n * (FQ_BYTES if field == "fq" else FR_BYTES)
        # the batch trick's ~3 products an element (the root's Euclid is word
        # subtractions and shifts, a few hundred multiplies)
        b_ms, b_by = bound(nbytes, product_ops(field, 3 * n))
        e_exp = ctx.modulus - 2
        fermat_ms, _ = bound(nbytes, product_ops(field, n * (e_exp.bit_length() + bin(e_exp).count("1"))))
        big = n > (1 << 20)
        shapes.append({
            "shape": f"{field} [{n}, {ctx.L}]", "max_abs_err": e, "zeros": int(zero.sum()),
            "ms": time_ms(torch, lambda: bi.inv_kernel(ctx, x), reps=10),
            "plain_ms": time_ms(torch, lambda: bi.inv_mod(ctx, x), reps=1 if big else 3, warmup=0 if big else 1),
            "bound_ms": b_ms, "bound_by": b_by, "fermat_bound_ms": fermat_ms,
        })
    head = shapes[0]
    return {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/field.cu",
        "replaces": "marlin_tpu/ops/pallas/field.py:126",
        "max_abs_err": max(r["max_abs_err"] for r in shapes), "shape": head["shape"],
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None, "shapes": shapes,
        "note": "bound: 3 products an element (the batch trick); fermat_bound_ms: the TPU kernel's "
                "x^(N-2), N-2's bits squarings and its set bits products an element",
    }


def stage_plan(ntt, n: int, inverse: bool, dev) -> tuple:
    """(log2 of the radix-2 transforms that kernel 3 runs, their twiddle
    table, the input scale): n's own for a power of two, the inner
    transforms of its Cooley-Tukey split for a mixed-radix size."""
    if n & (n - 1) == 0:
        tw, scale = ntt._plan_tensors(n, inverse, dev)
        return n.bit_length() - 1, tw, scale
    _, n2, tw, _, _, scale = ntt._mixed_tensors(n, inverse, dev)
    return n2.bit_length() - 1, tw, scale


def ntt_rows(torch, np, rng, err) -> dict:
    """Kernel 3 at the prove's shapes: whole transforms forward and inverse
    against the plain route, then each stage kernel against its plain twin,
    timed: 3(a) forward (its gather) and inverse (its gather and n^-1),
    3(b) at the last stage.  A mixed-radix shape's stage kernels run its
    inner radix-2 transforms, as its transforms do."""
    from marlin_tpu_torch.ops import fr, ntt

    dev = torch.device(DEV)
    checks = []
    blocks, crosses, calls = [], [], {}
    for shape in NTT_PROVE_SHAPES:
        n, total = shape[-1], int(np.prod(shape))
        log_n = stage_plan(ntt, n, False, dev)[0]
        v = torch.as_tensor(random_elements(np, rng, fr.CTX, total), device=dev).reshape(*shape, fr.L)
        for inverse in (False, True):
            e = err(ntt.transform(v, inverse), ntt.transform(v, inverse, plain=True))
            checks.append({"shape": list(shape), "inverse": inverse, "max_abs_err": e})
        flat = v.reshape(-1, fr.L)
        log_b = min(log_n, ntt.BLOCK_LOG2)
        row = {"shape": f"{list(shape)}, {log_b} stages"}
        # forward (the gather), then inverse (the gather and n^-1)
        for label, inverse in (("", False), ("inverse_", True)):
            _, tw, scale = stage_plan(ntt, n, inverse, dev)
            kb = ntt.block_stages_kernel(flat, tw, log_b, log_n, scale)
            pb = ntt.block_stages_plain(flat, tw, log_b, log_n, scale)
            b_ms, b_by = bound(2 * total * FR_BYTES + ((1 << log_b) - 1) * FR_BYTES,
                               product_ops("fr", total // 2 * log_b + (total if inverse else 0)))
            row.update({
                f"{label}max_abs_err": err(kb, pb),
                f"{label}ms": time_ms(torch, lambda: ntt.block_stages_kernel(flat, tw, log_b, log_n, scale)),
                f"{label}plain_ms": time_ms(torch, lambda: ntt.block_stages_plain(flat, tw, log_b, log_n, scale),
                                            reps=3),
                f"{label}bound_ms": b_ms, f"{label}bound_by": b_by,
            })
        row["max_abs_err"] = max(row["max_abs_err"], row.pop("inverse_max_abs_err"))
        blocks.append(row)
        # the cross stages, a group a launch, on the inverse plan's block output
        groups = ntt.cross_groups(log_n, log_b)
        if groups:
            crosses.append(cross_row(torch, ntt, err, kb, pb, tw, groups, f"{list(shape)}", calls))
    # a shape whose cross stages split over two groups
    log_n, log_b = split_plan(ntt, fr.L)
    n = 1 << log_n
    tw, _ = ntt._plan_tensors(n, True, dev)
    x = torch.as_tensor(random_elements(np, rng, fr.CTX, n), device=dev)
    groups = ntt.cross_groups(log_n, log_b)
    crosses.append(cross_row(torch, ntt, err, x, x, tw, groups, f"[{n}], block 2^{log_b} (split)", calls))
    device = device_times(torch, calls)
    for r in crosses:
        r["device_ms"] = device[r["shape"]]
        r["reached"] = r["bound_ms"] / r["device_ms"]
    # ntt_many == per-poly ntt, and intt(ntt(p)) == p
    n16 = FR_N
    polys = [torch.as_tensor(random_elements(np, rng, fr.CTX, n16 // 2 - 3 * i), device=dev) for i in range(4)]
    for p, m in zip(polys, ntt.ntt_many(polys, n16)):
        require(torch.equal(m, ntt.ntt(p, n16)), "ntt_many != ntt")
        require(torch.equal(ntt.intt(m)[: p.shape[0]], p), "intt(ntt(p)) != p")
    e_whole = max(c["max_abs_err"] for c in checks)
    out = {}
    for name, rows in (("ntt_block_stages", blocks), ("ntt_cross_stage", crosses)):
        head = next(r for r in rows if r["shape"].startswith(f"{[FR_N]},"))  # |K| alone, the earlier PRs' row
        out[name] = {
            "route": "cuda", "source": "marlin_tpu_torch/csrc/ntt.cu",
            "replaces": "marlin_tpu/ops/pallas/ntt.py:91",
            "max_abs_err": max([e_whole] + [r["max_abs_err"] for r in rows]), "shape": head["shape"],
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None, "shapes": rows,
        }
    out["ntt_cross_stage"]["device_ms"] = next(r["device_ms"] for r in crosses if r["shape"].startswith(f"{[FR_N]},"))
    out["ntt_block_stages"]["checks"] = checks
    return out


def cross_row(torch, ntt, err, kb, pb, tw, groups, label, calls) -> dict:
    """Kernel 3(b) over `groups` (one launch each) on a copy of `kb`, against
    the plain stages on `pb` (equal to kb), timed; the call goes into
    `calls` for its device time.  Bound: each group reads and writes every
    element once and reads its stages' twiddle rows once; a butterfly a
    product."""
    from marlin_tpu_torch.ops import fr

    total = kb.shape[0]
    got = kb.clone()
    want = pb
    for s0, s1 in groups:
        ntt.cross_stages_kernel(got, tw, s0, s1)
        want = ntt.cross_stages_plain(want, tw, s0, s1)
    stages = sum(s1 - s0 for s0, s1 in groups)
    nbytes = sum(2 * total * FR_BYTES + ((1 << s1) - (1 << s0)) * FR_BYTES for s0, s1 in groups)
    b_ms, b_by = bound(nbytes, product_ops("fr", total // 2 * stages))
    scratch = kb.clone()

    def run():
        for s0, s1 in groups:
            ntt.cross_stages_kernel(scratch, tw, s0, s1)

    def plain():
        y = pb
        for s0, s1 in groups:
            y = ntt.cross_stages_plain(y, tw, s0, s1)
        return y

    shape = f"{label}, stages {groups[0][0]}-{groups[-1][1] - 1}"
    calls[shape] = (run, "cross_stages_kernel", len(groups))
    return {"shape": shape, "groups": [list(g) for g in groups], "launches": len(groups),
            "max_abs_err": err(got, want), "ms": time_ms(torch, run),
            "plain_ms": time_ms(torch, plain, reps=3), "bound_ms": b_ms, "bound_by": b_by,
            "elements": total, "limbs": fr.L}


def split_plan(ntt, L: int) -> tuple:
    """(log_n, log_b): a radix-2 transform whose cross stages kernel 3(b)
    splits over two groups: the smallest past one whole group above the
    2^10 block, within the field's 2-adicity, else a smaller block."""
    from marlin_tpu_torch.fields import active as P

    log_n = 10
    while len(ntt.cross_groups(log_n, ntt.BLOCK_LOG2, L)) < 2 and log_n < P.FR_TWO_ADICITY:
        log_n += 1
    log_b = max(b for b in range(1, ntt.BLOCK_LOG2 + 1) if len(ntt.cross_groups(log_n, b, L)) == 2)
    return log_n, log_b


def curve_points(np, n: int, seed: int) -> list:
    """n affine multiples of the generator by seeded nonzero scalars: the
    native C fixed-base routine for BLS12-381, kernel 4's ladder on the card
    and one normalization for a curve the C runtime does not carry."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.fields import native_curve as nc
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops import msm

    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(40), "little") % (P.R_MODULUS - 1) + 1 for _ in range(n)]
    if nc.available():
        return hc.g1_fixed_base_powers(hc.G1_GEN, ks)
    return cd.to_affine_ints_host(cd.normalize_batch(msm.fixed_base_powers(hc.G1_GEN, ks, DEV)))


def fold_layout(torch, table, jobs, seed: int):
    """Lane-major merged layouts [J·nb, cap] of the table MSM for jobs of
    (offset, size) with seeded random scalars, padded as msm_fixed_many
    pads them (all sizes must pad to one group)."""
    from marlin_tpu_torch.ops import msm
    from marlin_tpu_torch.utils.rand import ZkRng

    dev = table.xy.device
    n_j = -(-max(n for _, n in jobs) // msm._FIXED_QUANT) * msm._FIXED_QUANT
    scal = torch.zeros((len(jobs), n_j, 16), dtype=torch.int32, device=dev)
    for j, (_, n) in enumerate(jobs):
        limbs = ZkRng(seed + j).rand_fr_limbs(n).astype("int32")
        scal[j, :n] = torch.as_tensor(limbs, device=dev)
    bucket, enc, _, _ = msm._job_digits(table, scal, [off for off, _ in jobs])
    nb = (1 << (table.c - 1)) + 1
    cap = msm._merged_cap(n_j, table.c, table.num_windows)
    layouts, _ = msm._merged_layouts_batched(bucket, enc, nb, cap)
    return layouts.reshape(len(jobs) * nb, cap)


def classic_fold_layout(torch, np, pts, seed: int):
    """Lane-major layouts [windows·nb, cap] of a classic MSM over the points
    with seeded random scalars, as msm_pippenger folds them: its windows
    whose buckets fit their capacity (the others take its masked sums), as
    many as one fold launch takes (16 of 1024 buckets at BLS12-381's 2^16)."""
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops import msm
    from marlin_tpu_torch.utils.rand import ZkRng

    n = len(pts) - 1  # the prove's largest classic jobs hold 2^16 - 1 points
    points = cd.from_affine_ints(pts[:n], DEV)
    scal16 = torch.as_tensor(ZkRng(seed).rand_fr_limbs(n).astype("int32"), device=DEV)
    c = min(13, max(6, n.bit_length() - 6))
    num_windows, nb, cap = msm._classic_shape(n, c)
    d = msm._window_digits(points, scal16, c, range(num_windows))
    counts = msm._bucket_counts(d, nb).cpu().numpy()
    normal = [w for w in range(num_windows) if counts[w, 1:].max(initial=0) <= cap]
    d = d[normal[: msm._CLASSIC_MAX_SLOTS // (nb * cap)]]
    layouts, spill = msm._window_layout_device(d, nb, cap)
    require(int(spill) == 0, "classic fold layout spilled")
    return layouts.reshape(-1, cap)


def phase_curve_kernels(torch, np) -> dict:
    """Kernels 4 and 5 against their plain versions at the main path's shapes."""
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve, fq, msm
    from marlin_tpu_torch.ops import curve_device as cd

    dev = torch.device(DEV)
    results = {}

    def err(ks, ps) -> int:
        return max(int((k.to(torch.int64) - p.to(torch.int64)).abs().max().item()) for k, p in zip(ks, ps))

    pts = curve_points(np, CURVE_N, 5)
    # edge cases: identities on either side, P + P, P + (-P)
    a, b = list(pts), pts[1:] + pts[:1]
    a[0], b[1], b[2], a[3], b[3] = None, None, a[2], a[4], hc.g1_neg(a[4])
    A, B = cd.from_affine_ints(a, dev), cd.from_affine_ints(b, dev)
    S = curve.add_kernel(A, B)
    e_add = err(S, curve.add_plain(A, B))
    torch.cuda.synchronize()
    require(cd.to_affine_ints(tuple(c[:8] for c in S)) == [hc.g1_add(x, y) for x, y in zip(a[:8], b[:8])],
            "g1_add: affine sums differ from the host's")
    # Jacobian operands (Z != 1): the timed shapes
    e_add = max(e_add, err(curve.add_kernel(S, B), curve.add_plain(S, B)))
    e_dbl = max(err(curve.double_kernel(S), curve.double_plain(S)),
                err(curve.double_kernel(A), curve.double_plain(A)))
    # the bucket scans' size: 3 windows of 513 buckets (the 2^14 prove's round 3)
    Ss, Bs = (tuple(t[:SCAN_N].contiguous() for t in p) for p in (S, B))
    e_scan = max(err(curve.add_kernel(Ss, Bs), curve.add_plain(Ss, Bs)),
                 err(curve.double_kernel(Ss), curve.double_plain(Ss)))
    n = CURVE_N
    b_ms, b_by = bound(9 * n * FQ_BYTES, product_ops("fq", n * 16))
    s_ms, s_by = bound(9 * SCAN_N * FQ_BYTES, product_ops("fq", SCAN_N * 16))
    results["g1_add"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/curve.cu",
        "replaces": "marlin_tpu/ops/pallas/curve.py:201",
        "max_abs_err": max(e_add, e_scan), "shape": f"[{n}] Jacobian + Jacobian",
        "ms": time_ms(torch, lambda: curve.add_kernel(S, B)),
        "plain_ms": time_ms(torch, lambda: curve.add_plain(S, B), reps=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "scans": {"shape": f"[{SCAN_N}] Jacobian + Jacobian", "max_abs_err": e_scan,
                  "ms": time_ms(torch, lambda: curve.add_kernel(Ss, Bs)),
                  "plain_ms": time_ms(torch, lambda: curve.add_plain(Ss, Bs), reps=3, warmup=1),
                  "bound_ms": s_ms, "bound_by": s_by},
    }
    b_ms, b_by = bound(6 * n * FQ_BYTES, product_ops("fq", n * 7))
    results["g1_double"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/curve.cu",
        "replaces": "marlin_tpu/ops/pallas/curve.py:201",
        "max_abs_err": max(e_dbl, e_scan), "shape": f"[{n}] Jacobian",
        "ms": time_ms(torch, lambda: curve.double_kernel(S)),
        "plain_ms": time_ms(torch, lambda: curve.double_plain(S), reps=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    # kernel 5: the table of these points at the 2^14 prove's c, its largest fold
    c = msm._fixed_c(n)
    table = msm.build_fixed_table(cd.from_affine_ints(pts, dev), c)
    results["g1_scalar_mul"] = scalar_mul_row(torch, np, pts, S, table)
    W = table.num_windows
    rows = [0, n + 7, (W - 1) * n + 9]
    x, y = curve.unpack_xy_rows(table.xy[rows])
    got = cd.to_affine_ints_host((x, y, fq.ones((3,), dev)))
    require(got == [hc.g1_mul(pts[r % n], 1 << (c * (r // n))) for r in rows],
            "build_fixed_table: rows differ from the host's 2^(c w) P")
    layout = fold_layout(torch, table, FOLD_JOBS, 11)
    # the classic Pippenger's largest fold launch: 16 windows of the 2^14
    # prove's 65,535-point MSMs (c = 10, cap 128) over the points themselves
    classic = classic_fold_layout(torch, np, pts, 12)
    xy = curve.pack_points_xy(*cd.from_affine_ints(pts, dev)[:2])
    # a lane whose sub-row meets P == Q: the fast fold flags it, the exact one sums it
    small = torch.zeros((4, 3 * curve.FOLD_SUBROWS), dtype=torch.int32, device=dev)
    small[:, :40] = torch.arange(1, 41, device=dev, dtype=torch.int32)
    small[2, 5] = small[2, 5 + curve.FOLD_SUBROWS] = -17
    checks = []
    e_fold = 0
    for name, tbl, lay in (("table", table.xy, layout), ("classic", xy, classic), ("p_eq_q", table.xy, small)):
        for exact in (False, True):
            kp, kf = curve.bucket_fold_kernel(tbl, lay, exact)
            pp, pf = curve.bucket_fold_plain(tbl, lay, exact)
            e = max(err(kp, pp), abs(int(kf) - int(pf)))
            if name == "p_eq_q":
                require(int(kf) == (0 if exact else 1), f"bucket_fold flag {int(kf)} with exact={exact}")
            checks.append({"layout": name, "exact": exact, "lanes": lay.shape[0], "cap": lay.shape[1],
                           "subrows": curve.fold_subrows(*lay.shape), "flags": int(kf), "max_abs_err": e})
            e_fold = max(e_fold, e)
    require(curve.fold_subrows(*layout.shape) == curve.FOLD_SUBROWS, "the table fold left 32 sub-rows")

    def fold_bound(lay):
        filled = int((lay != 0).sum())
        lanes, cap = lay.shape
        return filled, bound(filled * FQ_BYTES + lanes * cap * 4 + lanes * (3 * FQ_BYTES + 4),
                             product_ops("fq", filled * 11))

    c_filled, (c_ms, c_by) = fold_bound(classic)
    filled, (b_ms, b_by) = fold_bound(layout)
    lanes, cap = layout.shape
    results["bucket_fold"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/curve.cu",
        "replaces": "marlin_tpu/ops/pallas/curve.py:414",
        "max_abs_err": e_fold, "checks": checks,
        "shape": f"[{lanes}, {cap}] layout ({len(FOLD_JOBS)} jobs, c={c}), {filled} filled slots, "
                 f"{curve.fold_subrows(lanes, cap)} sub-rows",
        "ms": time_ms(torch, lambda: curve.bucket_fold_kernel(table.xy, layout)),
        "plain_ms": time_ms(torch, lambda: curve.bucket_fold_plain(table.xy, layout), reps=1, warmup=0),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "classic": {"shape": f"{list(classic.shape)} layout, {c_filled} filled slots, "
                             f"{curve.fold_subrows(*classic.shape)} sub-rows",
                    "ms": time_ms(torch, lambda: curve.bucket_fold_kernel(xy, classic)),
                    "bound_ms": c_ms, "bound_by": c_by},
    }
    results["combine_windows"] = combine_windows_row(torch, np, pts)
    torch.cuda.synchronize()
    for name, r in results.items():
        require(r["max_abs_err"] == 0, f"{name} disagrees with its plain version: {r}")
    return results


def scalar_mul_row(torch, np, pts, jac, table) -> dict:
    """Kernel 4's ladder at the 2^14 prove's shape before the digit route
    (2 points, 255 bits) and at 512 points with identity points, a Jacobian
    point and the scalars 0, 1 and r - 1; then the table route's shared
    ladder over c-bit digits."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops.limbs import ints_to_limbs
    from marlin_tpu_torch.utils.rand import ZkRng

    dev = torch.device(DEV)
    r = P.R_MODULUS

    def err(ks, ps) -> int:
        return max(int((k.to(torch.int64) - p.to(torch.int64)).abs().max().item()) for k, p in zip(ks, ps))

    def case(n, seed):
        ks = ZkRng(seed).rand_fr_list(n)
        affs = list(pts[:n])
        if n > 4:
            ks[:4] = [0, 1, r - 1, r - 1]
            affs[3] = affs[9] = None
        P_ = cd.from_affine_ints(affs, dev)
        for t, j in zip(P_, jac):  # one point off affine form
            t[n - 1] = j[n - 1]
        affs[n - 1] = cd.to_affine_ints(tuple(t[n - 1 : n] for t in jac))[0]
        scal = torch.as_tensor(ints_to_limbs(ks, 16).astype(np.int32), device=dev)
        return P_, scal, affs, ks

    out = {}
    for label, n in (("ladder", LADDER_N), ("wide", LADDER_WIDE_N)):
        P_, scal, affs, ks = case(n, 300 + n)
        plain = curve.scalar_mul_plain(P_, scal, P.FR_BITS)
        got = curve.scalar_mul_kernel(P_, scal, P.FR_BITS)
        torch.cuda.synchronize()
        check = min(n, 12)
        require(cd.to_affine_ints(tuple(t[:check] for t in got))
                == [hc.g1_mul(p, k) if p else None for p, k in zip(affs[:check], ks[:check])],
                f"g1_scalar_mul: affine multiples differ from the host's ({label})")
        rec = {"shape": f"[{n}] points x {P.FR_BITS} bits", "max_abs_err": err(got, plain),
               "ms": time_ms(torch, lambda: curve.scalar_mul_kernel(P_, scal, P.FR_BITS), reps=5)}
        adds = sum(bin(k).count("1") for k in ks)
        b_ms, b_by = bound(n * (6 * FQ_BYTES + 64), product_ops("fq", n * P.FR_BITS * 7 + adds * 16))
        most = max(bin(k).count("1") for k in ks)
        rec.update(
            bound_ms=b_ms, bound_by=b_by,
            chain_floor_ms=chain_floor_ms(P.FR_BITS * DOUBLING_LEVELS + most * ADD_LEVELS),
            plain_ms=time_ms(torch, lambda: curve.scalar_mul_plain(P_, scal, P.FR_BITS), reps=1, warmup=0),
        )
        out[label] = rec
    digits = digit_route_row(torch, np, pts, table)
    row = out["ladder"]
    return {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/chain.cu",
        "replaces": "marlin_tpu/ops/pallas/curve.py:201",
        "max_abs_err": max(row["max_abs_err"], out["wide"]["max_abs_err"], digits["max_abs_err"]),
        "shape": row["shape"], "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "chain_floor_ms": row["chain_floor_ms"], "variants": {"ladder": row, "wide": out["wide"]},
        "digit_route": digits,
    }


def digit_route_row(torch, np, pts, table) -> dict:
    """The table route's shared ladder (ops/msm.py::_shared_ladder) at the
    2^14 prove's shape: round 1's two one-point tails at c = 10, W = 26, as
    a fixed-table job list against the host MSM and against its plain run
    on a copy of the table on the CPU; then items with the scalars 0 and
    r - 1 and of unequal length."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import cuda, curve, fr, msm
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.utils.rand import ZkRng

    r = P.R_MODULUS
    N = table.n_base
    cpu_table = msm.FixedBaseTable(table.xy.cpu(), table.c, table.num_windows, N)
    # the prove's tails: one point each past a 2^14 head, at offsets 0 and 1
    tails = [(MAIN_HEAD, ZkRng(41).rand_fr_list(1)), (MAIN_HEAD + 1, ZkRng(42).rand_fr_list(1))]
    edges = [(7, [0, r - 1, 5]), (N - 2, [r - 1, 0]), (100, [0])]
    checks, e_max, timing = [], 0, None
    for name, items in (("prove_tails", tails), ("edges", edges)):
        dev_items = [(off, fr.from_ints(ks, DEV)) for off, ks in items]
        cuda.reset_launches()
        got = msm._shared_ladder(table, dev_items)
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        plain = msm._shared_ladder(cpu_table, [(off, fr.from_ints(ks, "cpu")) for off, ks in items])
        e = max(int((g.cpu().to(torch.int64) - p.to(torch.int64)).abs().max()) for g, p in zip(got, plain))
        want = [hc.g1_msm(pts[off : off + len(ks)], ks) for off, ks in items]
        require(cd.to_affine_ints(got) == want, f"shared ladder ({name}) differs from the host MSM")
        jobs = msm.msm_fixed_many(table, dev_items)  # items of one point or a few: the ladder
        require(cd.to_affine_ints(tuple(torch.cat([j[i] for j in jobs]) for i in range(3))) == want,
                f"fixed-table job list ({name}) differs from the host MSM")
        require(launches["g1_scalar_mul"] == 1, f"shared ladder ({name}): {launches['g1_scalar_mul']} ladder launches")
        checks.append({"items": [[off, len(ks)] for off, ks in items], "max_abs_err": e,
                       "launches": {k: v for k, v in launches.items() if v}})
        e_max = max(e_max, e)
        if name == "prove_tails":
            timing = dev_items
    pairs = len(timing) * table.num_windows
    scal16 = torch.as_tensor(np.stack([np.asarray([k >> (16 * j) & 0xFFFF for j in range(16)], np.int32)
                                       for _, ks in tails for k in ks]))
    d = msm._signed_digits(scal16, table.c, table.num_windows)
    set_bits = sum(bin(int(v)).count("1") for v in d.abs().reshape(-1).tolist())
    most = max(bin(int(v)).count("1") for v in d.abs().reshape(-1).tolist())
    b_ms, b_by = bound(pairs * (6 * FQ_BYTES + 64) + len(tails) * 3 * FQ_BYTES,
                       product_ops("fq", pairs * table.c * 7 + set_bits * 16 + (pairs - len(tails)) * 16))
    levels = (table.num_windows - 1).bit_length()
    return {
        "shape": f"{len(tails)} items x 1 point x {table.num_windows} windows, c={table.c}",
        "max_abs_err": e_max, "checks": checks, "pairs": pairs,
        "ms": time_ms(torch, lambda: msm._shared_ladder(table, timing), reps=10),
        "plain_ms": time_ms(torch, lambda: msm._shared_ladder(
            cpu_table, [(off, fr.from_ints(ks, "cpu")) for off, ks in tails]), reps=3),
        "bound_ms": b_ms, "bound_by": b_by,
        "chain_floor_ms": chain_floor_ms(table.c * DOUBLING_LEVELS + most * ADD_LEVELS + levels * ADD_LEVELS),
    }


def combine_windows_row(torch, np, pts) -> dict:
    """Kernel 6 at the prove's shape (c = 10, W = 26) on Jacobian window
    sums with identities among them, and at 128 sums (c = 2)."""
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import curve
    from marlin_tpu_torch.ops import curve_device as cd

    dev = torch.device(DEV)

    def err(ks, ps) -> int:
        return max(int((k.to(torch.int64) - p.to(torch.int64)).abs().max().item()) for k, p in zip(ks, ps))

    def sums(W, seed):
        rng = np.random.default_rng(seed)
        a = [pts[int(i)] for i in rng.choice(len(pts), 2 * W, replace=False)]
        A = cd.from_affine_ints(a[:W], dev)
        S = curve.add_kernel(A, cd.from_affine_ints(a[W:], dev))  # Z != 1
        ident = cd.identity((2,), dev)
        for t, i in zip(S, ident):
            t[torch.as_tensor([0, W // 2], device=dev)] = i
        affs = [None] + [hc.g1_add(x, y) for x, y in zip(a[1:W], a[W + 1 :])]
        affs[W // 2] = None
        return tuple(t[:, None].contiguous() for t in S), affs

    c, W = COMBINE_C, COMBINE_W
    stacked, affs = sums(W, 21)
    horner = None
    for w, s in enumerate(affs):
        horner = hc.g1_add(horner, hc.g1_mul(s, 1 << (c * w)) if s else None)
    plain = curve.combine_windows_plain(stacked, c)
    wide, _ = sums(curve.COMBINE_MAX, 22)
    wide_plain = curve.combine_windows_plain(wide, 2)
    got = curve.combine_windows_kernel(stacked, c)
    require(cd.to_affine_ints(got) == [horner], "combine_windows: the sum differs from the host's")
    checks = [{"c": c, "W": W, "max_abs_err": err(got, plain)},
              {"c": 2, "W": curve.COMBINE_MAX,
               "max_abs_err": err(curve.combine_windows_kernel(wide, 2), wide_plain)}]
    # all windows' doublings (7 products each) over the card's peak rate; the
    # chain floor: the longest window's doublings and the tree's adds, levels deep
    doublings = c * W * (W - 1) // 2
    b_ms, b_by = bound((W + 1) * 3 * FQ_BYTES, product_ops("fq", doublings * 7 + (W - 1) * 16))
    return {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/chain.cu",
        "replaces": "marlin_tpu/ops/pallas/curve.py:476",
        "max_abs_err": max(ch["max_abs_err"] for ch in checks), "checks": checks,
        "shape": f"[{W}, 1] Jacobian window sums, c={c}", "chain_doublings": c * (W - 1),
        "ms": time_ms(torch, lambda: curve.combine_windows_kernel(stacked, c)),
        "plain_ms": time_ms(torch, lambda: curve.combine_windows_plain(stacked, c), reps=1, warmup=0),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "chain_floor_ms": chain_floor_ms(c * (W - 1) * DOUBLING_LEVELS + (W - 1).bit_length() * ADD_LEVELS),
    }


class _OneConstraint:
    """x * y = out with x = 3, y = 5, out = 15 (public)."""

    def generate_constraints(self, cs):
        from marlin_tpu_torch.snark.r1cs import lc

        x = cs.new_witness_variable(lambda: 3)
        y = cs.new_witness_variable(lambda: 5)
        out = cs.new_input_variable(lambda: 15)
        cs.enforce_constraint(lc(x), lc(y), lc(out))


class DummyCircuit:
    """The bench circuit (reference benches/bench.rs:25-67)."""

    def __init__(self, a, b, num_variables, num_constraints):
        self.a, self.b = a, b
        self.num_variables = num_variables
        self.num_constraints = num_constraints

    def generate_constraints(self, cs):
        from marlin_tpu_torch.fields import active as P
        from marlin_tpu_torch.snark.r1cs import lc

        R = P.R_MODULUS
        a = cs.new_witness_variable(lambda: self.a)
        b = cs.new_witness_variable(lambda: self.b)
        c = cs.new_input_variable(lambda: self.a * self.b % R)
        for _ in range(self.num_variables - 3):
            cs.new_witness_variable(lambda: self.a)
        for _ in range(self.num_constraints - 1):
            cs.enforce_constraint(lc(a), lc(b), lc(c))
        cs.enforce_constraint(lc(), lc(), lc())


def _rejects(Marlin, vk, inputs, proof_bytes, rng, device) -> bool:
    from marlin_tpu_torch.snark.data_structures import Proof

    try:
        proof = Proof.from_bytes(proof_bytes)
    except ValueError:
        return True
    return not Marlin.verify(vk, inputs, proof, rng, device=device)


def phase_small() -> dict:
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.utils.rand import test_rng

    out = {}
    proofs = {}
    for device in ("cpu", DEV):
        t = time.perf_counter()
        rng = test_rng()
        srs = Marlin.universal_setup(32, 32, 96, rng, device=device)
        pk, vk = Marlin.index(srs, _OneConstraint(), device=device)
        proof = Marlin.prove(pk, _OneConstraint(), rng, device=device)
        proofs[device] = proof.to_bytes()
        out[f"{device}_s"] = time.perf_counter() - t
    require(proofs["cpu"] == proofs[DEV], "card proof bytes differ from the CPU's")
    require(Marlin.verify(vk, [15], proof, rng, device=DEV), "card proof does not verify")
    require(_rejects(Marlin, vk, [16], proofs[DEV], rng, DEV), "wrong input accepted")
    flipped = bytearray(proofs[DEV])
    flipped[len(flipped) // 2] ^= 0x01
    require(_rejects(Marlin, vk, [15], bytes(flipped), rng, DEV), "flipped byte accepted")
    out.update(proof_bytes=len(proofs[DEV]), bytes_equal=True, verifies=True, rejects=True)
    return out


def phase_medium(torch) -> dict:
    """DummyCircuit at 2^11 on the CPU and on the card: equal proof bytes,
    with every commit on the card's table MSM (an SRS of 8192 powers)."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import cuda
    from marlin_tpu_torch.snark import kzg
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.utils.rand import test_rng

    n = 1 << MEDIUM_LOG2
    out = {"num_constraints": n}
    proofs = {}
    for device in ("cpu", DEV):
        rng = test_rng()
        a, b = rng.rand_fr(), rng.rand_fr()
        circ = DummyCircuit(a, b, num_variables=10, num_constraints=n)
        if device == DEV:
            torch.cuda.synchronize()
            cuda.reset_launches()
            reruns = kzg.STATS["exact_reruns"]
        t = time.perf_counter()
        srs = Marlin.universal_setup(n, n, 3 * n, rng, device=device)
        pk, vk = Marlin.index(srs, circ, device=device)
        proof = Marlin.prove(pk, circ, rng, device=device)
        if device == DEV:
            torch.cuda.synchronize()
            out["launches"] = dict(cuda.LAUNCHES)
            out["exact_reruns"] = kzg.STATS["exact_reruns"] - reruns
            out["srs_powers"] = srs.powers_of_g[0].shape[0]
        out[f"{device}_s"] = time.perf_counter() - t
        proofs[device] = proof.to_bytes()
    require(out["srs_powers"] > kzg._HOST_POWERS_MAX, "medium SRS small enough for the host branch")
    require(proofs["cpu"] == proofs[DEV], "medium: card proof bytes differ from the CPU's")
    require(out["launches"]["bucket_fold"] > 0, "medium: the bucket fold was not launched")
    require(Marlin.verify(vk, [a * b % P.R_MODULUS], proof, rng, device=DEV), "medium proof does not verify")
    out.update(proof_bytes=len(proofs[DEV]), bytes_equal=True, verifies=True)
    return out


def phase_main(torch) -> tuple:
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import cuda, ntt
    from marlin_tpu_torch.snark import ahp, kzg
    from marlin_tpu_torch.snark.domains import compute_size_of_domain
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.utils import profiling
    from marlin_tpu_torch.utils.rand import test_rng

    n = 1 << MAIN_LOG2
    rng = test_rng()
    a, b = rng.rand_fr(), rng.rand_fr()
    circ = DummyCircuit(a, b, num_variables=10, num_constraints=n)
    public = [a * b % P.R_MODULUS]
    rec = {"num_constraints": n}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        rec[f"{name}_s"] = time.perf_counter() - t
        return res

    cuda.reset_launches()
    srs = timed("setup", lambda: Marlin.universal_setup(n, n, 3 * n, rng, device=DEV))
    pk, vk = timed("index", lambda: Marlin.index(srs, circ, device=DEV))
    # the prove's MSM jobs, host MSM calls and exact reruns, counted around it
    before = dict(cuda.LAUNCHES)
    copies_before = dict(cuda.BINOP_COPIES)
    reruns = kzg.STATS["exact_reruns"]
    rng_at_prove = copy.deepcopy(rng)
    profiling.enable(True)
    profiling.collect()
    with counted_msm_calls() as seen, watched_transforms() as watched, recorded_ladders() as ladders, \
            contextlib.redirect_stdout(io.StringIO()):
        proof = timed("prove", lambda: Marlin.prove(pk, circ, rng, device=DEV))
    spans = profiling.collect()
    profiling.enable(False)
    prove_launches = {k: v - before[k] for k, v in cuda.LAUNCHES.items()}
    prove_copies = {k: v - copies_before[k] for k, v in cuda.BINOP_COPIES.items()}
    prove_reruns = kzg.STATS["exact_reruns"] - reruns
    ok = timed("verify", lambda: Marlin.verify(vk, public, proof, rng, device=DEV))
    launches = dict(cuda.LAUNCHES)
    binop_by_op = {f"{f}.{k}": v for (f, k), v in sorted(cuda.BINOP_LAUNCHES.items())}

    info = pk.index.index_info
    h = compute_size_of_domain(info.num_constraints)
    rec.update(
        H=h,
        K=compute_size_of_domain(info.num_non_zero),
        mul_domain=compute_size_of_domain(3 * h + 1),
        srs_max_degree=ahp.max_degree(n, n, 3 * n),
        rounds_s={s["name"]: s["seconds"] for s in spans if s["depth"] == 1},
        launches=launches,
        prove_launches=prove_launches,
        binop_launches=binop_by_op,
        binop_copies=dict(cuda.BINOP_COPIES),
        prove_binop_copies=prove_copies,
        prove_msm_jobs=seen["jobs"],
        prove_exact_reruns=prove_reruns,
        prove_host_msm_calls=seen["host_calls"],
        prove_inversions=watched["inversions"],
        prove_transforms=watched["transforms"],
        prove_ladders=ladders,
        proof_bytes=proof.serialized_size(),
        verifies=bool(ok),
    )
    require(ok, "2^14 proof does not verify")
    require(
        not Marlin.verify(vk, [(public[0] + 1) % P.R_MODULUS], proof, rng, device=DEV),
        "2^14 proof accepted a wrong input",
    )
    require(rec["proof_bytes"] == 855, f"proof is {rec['proof_bytes']} B, expected 855")
    for k, v in launches.items():
        # the window combine serves the classic Pippenger only: phase classic
        require(v > 0 or k == "combine_windows", f"kernel {k} was not launched on the main path")
    # the prove's ladder (round 1's tails) is one launch; on the table route
    # it was the prove's only caller of the doubling kernel
    require(prove_launches["g1_scalar_mul"] == 1,
            f"the 2^14 prove launched the ladder {prove_launches['g1_scalar_mul']} times, expected once")
    # ... over c-bit digits and the table's window rows, not 255-bit scalars
    table_c = kzg._ensure_msm_table(pk.committer_key.pp).c
    require([lad["num_bits"] for lad in ladders] == [table_c],
            f"the 2^14 prove's ladder launches {ladders}, expected one of {table_c} bits")
    require(prove_launches["g1_double"] == 0,
            f"the 2^14 prove launched the doubling {prove_launches['g1_double']} times, expected none")
    require(prove_reruns == 0, f"the 2^14 prove reran {prove_reruns} MSM batches")
    # kernel 2: one launch per inversion; kernel 3: one 3(a) launch per
    # transform plus one 3(b) per group of stages above 2^10, no gather op outside the
    # kernel and no n^-1 product
    require(prove_launches["field_inv"] == len(watched["inversions"]) > 0
            and all(i["launches"] == 1 for i in watched["inversions"]),
            f"the prove's inversions: {watched['inversions']}, {prove_launches['field_inv']} launches")
    require(len(watched["transforms"]) > 0, "the prove ran no NTT")
    # kernel 3(b): one launch per group of cross stages, at most one a
    # transform wider than the block (was one a stage: 56 a prove)
    require(prove_launches["ntt_cross_stage"] <= MAX_PROVE_CROSS_LAUNCHES,
            f"the 2^14 prove launched 3(b) {prove_launches['ntt_cross_stage']} times")
    # kernel 1 reads every broadcast operand of the prove in place
    require(prove_copies["broadcast"] == 0, f"the 2^14 prove materialized broadcasts: {prove_copies}")
    for t in watched["transforms"]:
        log_n = t["shape"][-1].bit_length() - 1
        want = (1, len(ntt.cross_groups(log_n, min(log_n, ntt.BLOCK_LOG2)))) if log_n else (0, 0)
        require((t["block_launches"], t["cross_launches"]) == want and t["fr_mul_launches"] == 0
                and not set(t["ops"]) & GATHER_OPS, f"an NTT of the prove ran outside its kernels: {t}")
    require(seen["host_calls"] == 0, f"the 2^14 prove called the host MSM {seen['host_calls']} times")
    state = {"pk": pk, "vk": vk, "circ": circ, "public": public, "rng": rng_at_prove,
             "proof": proof.to_bytes()}
    return rec, state


# kernel 3(b)'s launches in the 2^14 prove: at most one for each 3(a) launch
# of a transform wider than the block (11 of them)
MAX_PROVE_CROSS_LAUNCHES = 11
# the aten ops a bit-reversal gather would run
GATHER_OPS = {"aten.index_select", "aten.index", "aten.gather", "aten.take"}


@contextlib.contextmanager
def watched_transforms():
    """Record each NTT transform (its kernel launches, its Fr product
    launches and the aten ops it dispatches) and each inversion (its kernel
    launches) while the context is open."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from marlin_tpu_torch.ops import cuda, ntt, routing

    seen = {"transforms": [], "inversions": []}
    transform, inv = ntt.transform, routing.inv

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(str(func.overloadpacket))
            return func(*args, **(kwargs or {}))

    with Ops():  # the first dispatch mode of a process takes seconds to set up
        torch.empty(1)

    def watched_transform(x, inverse, *args, **kwargs):
        before = dict(cuda.LAUNCHES)
        muls = cuda.BINOP_LAUNCHES.get(("fr", "mul"), 0)
        with Ops() as ops:
            y = transform(x, inverse, *args, **kwargs)
        seen["transforms"].append({
            "shape": list(x.shape[:-1]), "inverse": inverse,
            "block_launches": cuda.LAUNCHES["ntt_block_stages"] - before["ntt_block_stages"],
            "cross_launches": cuda.LAUNCHES["ntt_cross_stage"] - before["ntt_cross_stage"],
            "fr_mul_launches": cuda.BINOP_LAUNCHES.get(("fr", "mul"), 0) - muls,
            "ops": sorted(ops.names)})
        return y

    def watched_inv(ctx, x):
        before = cuda.LAUNCHES["field_inv"]
        y = inv(ctx, x)
        seen["inversions"].append({"field": ctx.name, "n": x.numel() // ctx.L,
                                   "launches": cuda.LAUNCHES["field_inv"] - before})
        return y

    ntt.transform, routing.inv = watched_transform, watched_inv
    try:
        yield seen
    finally:
        ntt.transform, routing.inv = transform, inv


@contextlib.contextmanager
def recorded_ladders():
    """Record each launch of the ladder kernel: its points and bits."""
    from marlin_tpu_torch.ops import curve

    seen = []
    kernel = curve.scalar_mul_kernel

    def recording(points, scalar_limbs, num_bits=255):
        out = kernel(points, scalar_limbs, num_bits)
        seen.append({"points": int(out[0].numel() // out[0].shape[-1]), "num_bits": num_bits})
        return out

    curve.scalar_mul_kernel = recording
    try:
        yield seen
    finally:
        curve.scalar_mul_kernel = kernel


@contextlib.contextmanager
def counted_msm_calls():
    """Record the MSM jobs of kzg._run_msm_jobs and count host MSM calls."""
    from marlin_tpu_torch.ops import msm
    from marlin_tpu_torch.snark import kzg

    seen = {"jobs": [], "host_calls": 0}
    run_jobs, host_msm = kzg._run_msm_jobs, msm._host_msm

    def recording_run(ck, js):
        seen["jobs"].extend((off, int(scal.shape[0])) for off, scal in js)
        return run_jobs(ck, js)

    def counting_host_msm(*args):
        seen["host_calls"] += 1
        return host_msm(*args)

    kzg._run_msm_jobs, msm._host_msm = recording_run, counting_host_msm
    try:
        yield seen
    finally:
        kzg._run_msm_jobs, msm._host_msm = run_jobs, host_msm


@contextlib.contextmanager
def classic_route():
    """MARLIN_TPU_MSM_TABLE=0: the prover's MSMs take the classic Pippenger."""
    old = os.environ.get("MARLIN_TPU_MSM_TABLE")
    os.environ["MARLIN_TPU_MSM_TABLE"] = "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MARLIN_TPU_MSM_TABLE")
        else:
            os.environ["MARLIN_TPU_MSM_TABLE"] = old


def phase_classic(torch, state) -> dict:
    """The main prove again from the same rng state with every MSM on the
    classic Pippenger: equal bytes, kernel 6 once per job, no host MSM."""
    from marlin_tpu_torch.ops import cuda
    from marlin_tpu_torch.snark import kzg
    from marlin_tpu_torch.snark.marlin import Marlin

    pk, circ = state["pk"], state["circ"]

    def prove(classic: bool):
        rng = copy.deepcopy(state["rng"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        with (classic_route() if classic else contextlib.nullcontext()):
            with contextlib.redirect_stdout(io.StringIO()):
                proof = Marlin.prove(pk, circ, rng, device=DEV)
        torch.cuda.synchronize()
        return proof, time.perf_counter() - t

    reruns = kzg.STATS["exact_reruns"]
    cuda.reset_launches()
    with counted_msm_calls() as seen:
        proof, first_s = prove(classic=True)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    rec = {"first_prove_s": first_s, "launches": launches, "msm_jobs": seen["jobs"],
           "host_msm_calls": seen["host_calls"], "exact_reruns": kzg.STATS["exact_reruns"] - reruns}
    require(proof.to_bytes() == state["proof"], "classic: proof bytes differ from the table route's")
    require(Marlin.verify(state["vk"], state["public"], proof, copy.deepcopy(state["rng"]), device=DEV),
            "classic: the proof does not verify")
    require(proof.serialized_size() == 855, f"classic: proof is {proof.serialized_size()} B")
    require(launches["combine_windows"] == len(seen["jobs"]) > 0,
            f"classic: {launches['combine_windows']} combines for {len(seen['jobs'])} MSM jobs")
    require(seen["host_calls"] == 0, f"classic: {seen['host_calls']} host MSM calls")
    require(rec["exact_reruns"] == 0, f"classic: {rec['exact_reruns']} exact reruns")
    steady = {"table": [], "classic": []}
    for classic in (False, True, True, False):
        proof, secs = prove(classic)
        require(proof.to_bytes() == state["proof"], "classic: a steady prove's bytes differ")
        steady["classic" if classic else "table"].append(secs)
    rec.update(steady_prove_s=steady, proof_bytes=855, bytes_equal=True, verifies=True)
    return rec


def phase_msm(torch, np, ck, jobs) -> dict:
    """The prove's job list with seeded scalars through the card's commit
    path, against the native host MSM; the public msm() on the card; then a
    repeated-scalar job."""
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import cuda, fr
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.ops.limbs import limbs_to_ints
    from marlin_tpu_torch.snark import kzg
    from marlin_tpu_torch.utils.rand import ZkRng

    powers = cd.to_affine_ints_host(ck.pp.powers_of_g)
    limbs = [ZkRng(100 + j).rand_fr_limbs(n) for j, (_, n) in enumerate(jobs)]
    dev_jobs = [(off, fr.from_canonical_limbs(l, DEV)) for (off, _), l in zip(jobs, limbs)]
    reruns = kzg.STATS["exact_reruns"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = kzg._run_msm_jobs(ck, dev_jobs)
    card_s = time.perf_counter() - t
    require(kzg.STATS["exact_reruns"] == reruns, "random scalars fired a fold flag")
    t = time.perf_counter()
    want = [hc.g1_msm(powers[off : off + n], limbs_to_ints(l)) for (off, n), l in zip(jobs, limbs)]
    host_s = time.perf_counter() - t
    require(got == want, "a job of the prove's list differs from the host MSM")

    public = phase_public_msm(torch, np, ck.pp.powers_of_g, powers)

    # one scalar for all the points: every window's entries share a bucket,
    # which overflows its capacity; the rerun on the classic path must be exact
    rep = np.repeat(ZkRng(7).rand_fr_limbs(1), REPEATED_N, axis=0)
    cuda.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        got_rep = kzg._run_msm_jobs(ck, [(0, fr.from_canonical_limbs(rep, DEV))])
    torch.cuda.synchronize()
    fired = kzg.STATS["exact_reruns"] - reruns
    require(fired == 1, f"the repeated-scalar job reran {fired} times, expected once")
    require("classic" in printed.getvalue(), "the rerun did not take the classic path")
    require(cuda.LAUNCHES["combine_windows"] == 1, "the classic rerun launched no window combine")
    require(got_rep == [hc.g1_msm(powers[:REPEATED_N], limbs_to_ints(rep))],
            "the exact rerun differs from the host MSM")
    return {"jobs": [list(j) for j in jobs], "card_s": card_s, "host_s": host_s,
            "equal": True, "public_msm": public,
            "repeated_scalar": {"n": REPEATED_N, "reruns": fired, "equal": True,
                                "launches": dict(cuda.LAUNCHES),
                                "printed": printed.getvalue().strip()}}


def phase_public_msm(torch, np, dev_powers, powers) -> dict:
    """The public msm() on card tensors against the host MSM: random
    scalars; duplicate points, whose fast fold flags and which msm() reruns
    exactly; an identity and a point off affine form; a batch below the
    classic Pippenger's minimum (the ladder)."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.fields import host_curve as hc
    from marlin_tpu_torch.ops import cuda, fq, fr, msm
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.utils.rand import ZkRng

    q = P.Q_MODULUS
    cases = {}

    def run(name, idx, edit=None):
        n = len(idx)
        scal = ZkRng(200 + len(cases)).rand_fr_list(n)
        ix = torch.as_tensor(idx, device=DEV)
        pts = tuple(t[ix].clone() for t in dev_powers)
        affs = [powers[i] for i in idx]
        if edit:
            edit(pts, affs)
        cuda.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = cd.to_affine_ints(msm.msm(pts, fr.from_ints(scal, DEV)))
        secs = time.perf_counter() - t
        ok = got == [hc.g1_msm(affs, scal)]
        cases[name] = {"n": n, "card_s": secs, "equal": ok, "launches": dict(cuda.LAUNCHES)}
        require(ok, f"msm() on the card differs from the host MSM: {name}")

    n_big = 1 << 14
    run("random", list(range(n_big)))
    # 16 points, each 128 times: sub-rows of the fold meet P == Q
    run("duplicates", [i % 16 for i in range(2048)])

    def identity_and_jacobian(pts, affs):
        pts[2][3] = 0  # Z = 0: the identity
        affs[3] = None
        z = 0x1234567
        x, y = affs[7]
        jac = fq.from_ints([x * z * z % q, y * z * z * z % q, z], DEV)
        for t, v in zip(pts, jac):
            t[7] = v

    run("identity_and_jacobian", list(range(100, 1600)), identity_and_jacobian)
    run("ladder", list(range(300)))
    require(cases["duplicates"]["launches"]["combine_windows"] == 2,
            "msm() did not rerun the duplicate-point MSM exactly")
    require(cases["ladder"]["launches"]["combine_windows"] == 0, "a ladder-sized msm() took the Pippenger")
    return cases


def phase_sonic(torch) -> dict:
    """MarlinSonic at 2^11 on the CPU and on the card, then at 2^14 on the card."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.snark.marlin import MarlinSonic
    from marlin_tpu_torch.utils.rand import test_rng

    out = {}
    proofs = {}
    for device, log2 in (("cpu", MEDIUM_LOG2), (DEV, MEDIUM_LOG2), (DEV, MAIN_LOG2)):
        n = 1 << log2
        rng = test_rng()
        a, b = rng.rand_fr(), rng.rand_fr()
        circ = DummyCircuit(a, b, num_variables=10, num_constraints=n)
        rec = {}

        def timed(name, fn):
            t = time.perf_counter()
            res = fn()
            if device == DEV:
                torch.cuda.synchronize()
            rec[f"{name}_s"] = time.perf_counter() - t
            return res

        srs = timed("setup", lambda: MarlinSonic.universal_setup(n, n, 3 * n, rng, device=device))
        pk, vk = timed("index", lambda: MarlinSonic.index(srs, circ, device=device))
        with counted_msm_calls() as seen:
            proof = timed("prove", lambda: MarlinSonic.prove(pk, circ, rng, device=device))
        rec["host_msm_calls"] = seen["host_calls"]
        rec["verifies"] = bool(MarlinSonic.verify(vk, [a * b % P.R_MODULUS], proof, rng, device=device))
        rec["proof_bytes"] = proof.serialized_size()
        proofs[(device, log2)] = proof.to_bytes()
        out[f"{device}_2^{log2}"] = rec
        require(rec["verifies"], f"sonic: the {device} proof at 2^{log2} does not verify")
        require(rec["proof_bytes"] == 759, f"sonic: proof is {rec['proof_bytes']} B, expected 759")
    require(proofs[("cpu", MEDIUM_LOG2)] == proofs[(DEV, MEDIUM_LOG2)],
            "sonic: card proof bytes differ from the CPU's")
    require(out[f"{DEV}_2^{MAIN_LOG2}"]["host_msm_calls"] == 0, "sonic: the 2^14 prove called the host MSM")
    out["bytes_equal_2^11"] = True
    return out


# --------------------------------------------------------------------------
# archives (snark/serial.py) and the mesh layer (parallel/)


def host_power_check(arrays: tuple) -> None:
    """The JAX package's load-time power check in host Python ints
    (marlin_tpu/snark/serial.py:150), beside which the card's is timed:
    limbs below 2^16, Z in {0, one}, residues below q, y^2 = x^3 + b."""
    import numpy as np

    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops.limbs import limbs_to_ints

    q = P.Q_MODULUS
    rinv, one = pow(P.FQ_MONT_R, -1, q), P.FQ_MONT_R % q
    if any((np.asarray(a) >> 16).any() for a in arrays):
        raise ValueError("archive limb out of range (>= 2^16)")
    xs, ys, zs = (limbs_to_ints(np.asarray(a)) for a in arrays)
    for x_m, y_m, z_m in zip(xs, ys, zs):
        if z_m == 0:
            continue
        if z_m != one:
            raise ValueError("non-affine Z in archive")
        if x_m >= q or y_m >= q:
            raise ValueError("coordinate residue out of range")
        x, y = x_m * rinv % q, y_m * rinv % q
        if (y * y - x * x % q * x - P.CURVE_B) % q:
            raise ValueError("off-curve point in archive")


def _tampered(np, src: str, dst: str, edit) -> str:
    """A copy of the archive `src` at `dst` with `edit(arrays, meta)` applied."""
    with np.load(src) as z:
        arrays = {k: z[k].copy() for k in z.files if k != "meta"}
        meta = json.loads(str(z["meta"]))
    edit(arrays, meta)
    np.savez(dst, meta=json.dumps(meta), **arrays)
    return dst


def serial_roundtrip(torch, np, state: dict, label: str, tamper: bool) -> dict:
    """The main path's SRS, lean prover key (no SRS) and verifier key saved
    and loaded on the card: the load's on-curve check launches kernel 1's
    Fq products and add; the loaded keys prove main's bytes, which the
    loaded verifier key accepts.  With `tamper` (BLS12-381's phase
    `serial`), the full prover key (its SRS embedded) round-trips too, and
    each tampered archive (a limb >= 2^16, a non-affine Z, a residue >= q,
    an off-curve power, a flipped G2 coordinate, a commitment off the
    curve) raises ValueError on the card.  The other curves' processes skip
    the full key: it holds the SRS and the lean key again, and its zlib
    write takes 8-11 s a curve."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import cuda, fq
    from marlin_tpu_torch.snark import serial
    from marlin_tpu_torch.snark.marlin import Marlin

    pk, vk = state["pk"], state["vk"]
    d = os.path.join(SMOKE_DIR, f"serial_{label}")
    os.makedirs(d, exist_ok=True)
    paths = {k: os.path.join(d, f"{k}.npz") for k in ("srs", "pk", "lean", "vk") if tamper or k != "pk"}
    rec = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        rec[f"{name}_s"] = time.perf_counter() - t
        return res

    pp = pk.committer_key.pp
    timed("save_srs", lambda: serial.save_srs(pp, paths["srs"]))
    if tamper:
        timed("save_pk", lambda: serial.save_index_pk(pk, paths["pk"]))
    timed("save_lean", lambda: serial.save_index_pk(pk, paths["lean"], include_srs=False))
    timed("save_vk", lambda: serial.save_index_vk(vk, paths["vk"]))
    rec["archive_mb"] = {k: os.path.getsize(v) / 1e6 for k, v in paths.items()}
    cuda.reset_launches()
    srs = timed("load_srs", lambda: serial.load_srs(paths["srs"], device=DEV))
    rec["load_srs_launches"] = {f"{f}.{op}": v for (f, op), v in sorted(cuda.BINOP_LAUNCHES.items())}
    require(cuda.BINOP_LAUNCHES.get(("fq", "mul"), 0) >= 6 and cuda.BINOP_LAUNCHES.get(("fq", "add"), 0) >= 2,
            f"{label}: the load's on-curve check ran no Fq kernel: {rec['load_srs_launches']}")
    require(all(torch.equal(a, b) for a, b in zip(srs.powers_of_g, pp.powers_of_g)), f"{label}: loaded powers differ")
    keys = {}
    if tamper:
        keys["pk"] = timed("load_pk", lambda: serial.load_index_pk(paths["pk"], device=DEV))
    keys["lean"] = timed("load_lean", lambda: serial.load_index_pk(paths["lean"], srs=srs, device=DEV))
    vk2 = timed("load_vk", lambda: serial.load_index_vk(paths["vk"], device=DEV))
    require(vk2.to_bytes() == vk.to_bytes(), f"{label}: the loaded verifier key differs")
    for name, key in keys.items():
        with contextlib.redirect_stdout(io.StringIO()):
            proof = timed(f"prove_{name}", lambda: Marlin.prove(key, state["circ"], copy.deepcopy(state["rng"]),
                                                               device=DEV))
        require(proof.to_bytes() == state["proof"], f"{label}: the proof from the loaded {name} differs from main's")
    require(Marlin.verify(vk2, state["public"], proof, copy.deepcopy(state["rng"]), device=DEV),
            f"{label}: the loaded verifier key rejects the proof")
    state["loaded_lean_pk"] = keys["lean"]
    # the power check alone: on the card (two host reads of flags) and in host ints
    rec["check_card_ms"] = time_ms(torch, lambda: serial._validate_powers_on_curve(srs.powers_of_g, "srs"),
                                   reps=5, warmup=1)
    with np.load(paths["srs"]) as z:
        arrays = tuple(z[f"pg_{a}"] for a in "xyz")
    t = time.perf_counter()
    host_power_check(arrays)
    rec["check_host_ms"] = (time.perf_counter() - t) * 1e3
    rec["check_points"] = int(arrays[0].shape[0])
    rec.update(bytes_equal=True, verifies=True)
    if not tamper:
        return rec

    q = P.Q_MODULUS

    def limb(a, m):
        a["pg_x"][2, 0] = 1 << 16

    def z(a, m):
        a["pgg_z"][5] = a["pgg_x"][5]

    def residue(a, m):
        x = sum(int(v) << (16 * i) for i, v in enumerate(a["pg_x"][1]))
        a["pg_x"][1] = [((x + q) >> (16 * i)) & 0xFFFF for i in range(fq.L)]

    def off_curve(a, m):
        a["pg_y"][3] = a["pg_y"][4]

    def beta_h(a, m):
        m["beta_h"][0][0] = int(m["beta_h"][0][0]) ^ 1

    def comm(a, m):
        m["index_comms"][0]["comm"][0] = int(m["index_comms"][0]["comm"][0]) ^ 1

    cases = {"limb": (limb, "srs", "limb out of range"), "z": (z, "srs", "non-affine Z"),
             "residue": (residue, "srs", "residue out of range"), "off_curve": (off_curve, "srs", "off-curve"),
             "beta_h": (beta_h, "srs", "beta_h"), "comm": (comm, "vk", "index_comm")}
    raised = {}
    for name, (edit, kind, want) in cases.items():
        path = _tampered(np, paths[kind], os.path.join(d, f"tampered_{name}.npz"), edit)
        load = serial.load_srs if kind == "srs" else serial.load_index_vk
        try:
            load(path, device=DEV)
            raised[name] = None
        except ValueError as e:
            raised[name] = str(e)
        require(raised[name] is not None and want in raised[name], f"{label}: tampered {name}: {raised[name]}")
    rec["tamper"] = raised
    return rec


def phase_serial(torch, np, main_rec: dict, state: dict) -> dict:
    """Phase `serial`: the 2^14 main path's archives round-trip on the card
    (`serial_roundtrip`, with the tamper cases), beside main's setup and
    index seconds; then the loaded lean key proves under the table's window
    widths (`window_width_proves`)."""
    rec = serial_roundtrip(torch, np, state, "bls12_381", tamper=True)
    rec.update(main_setup_s=main_rec["setup_s"], main_index_s=main_rec["index_s"])
    rec["load_s"] = rec["load_srs_s"] + rec["load_pk_s"] + rec["load_vk_s"]
    rec["window_widths"] = window_width_proves(torch, state, main_rec)
    return rec


# the table's window width under MARLIN_TPU_FIXED_C beside the default (c = 10 at 2^16 powers)
FIXED_C_CASES = ("12", None)


def window_width_proves(torch, state: dict, main_rec: dict) -> dict:
    """The loaded lean key proves main's bytes with the table's window
    width set by MARLIN_TPU_FIXED_C (12) and by default: for each, the
    first prove (which builds that width's table) and a steady one, whose
    commit spans are recorded beside the table's MB; main's commit spans
    beside them."""
    from marlin_tpu_torch.ops import msm
    from marlin_tpu_torch.snark import kzg
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.utils import profiling

    pk = state["loaded_lean_pk"]
    n_powers = pk.committer_key.pp.powers_of_g[0].shape[0]
    old = os.environ.pop("MARLIN_TPU_FIXED_C", None)
    out = {"main_commit_spans_s": {k: v for k, v in main_rec["rounds_s"].items() if k.startswith("Committing")}}
    try:
        for fixed in FIXED_C_CASES:
            if fixed is None:
                os.environ.pop("MARLIN_TPU_FIXED_C", None)
            else:
                os.environ["MARLIN_TPU_FIXED_C"] = fixed
            rec = {"c": msm._fixed_c(n_powers), "table_mb": kzg.msm_table_mb(n_powers)}
            for run in ("first", "steady"):
                profiling.enable(True)
                profiling.collect()
                torch.cuda.synchronize()
                t = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    proof = Marlin.prove(pk, state["circ"], copy.deepcopy(state["rng"]), device=DEV)
                torch.cuda.synchronize()
                rec[f"{run}_prove_s"] = time.perf_counter() - t
                spans = profiling.collect()
                profiling.enable(False)
                require(proof.to_bytes() == state["proof"],
                        f"serial: the prove at MARLIN_TPU_FIXED_C={fixed} differs from main's")
            rec["commit_spans_s"] = {sp["name"]: sp["seconds"] for sp in spans if sp["name"].startswith("Committing")}
            require(kzg._ensure_msm_table(pk.committer_key.pp).c == rec["c"],
                    f"serial: the table of MARLIN_TPU_FIXED_C={fixed} has another width")
            out[f"c{rec['c']}"] = rec
    finally:
        profiling.enable(False)
        if old is None:
            os.environ.pop("MARLIN_TPU_FIXED_C", None)
        else:
            os.environ["MARLIN_TPU_FIXED_C"] = old
    return out


def mesh_of(torch, k: int):
    """A one-process mesh of k shards: k distinct cards where the machine has
    them, else the one card k times."""
    from marlin_tpu_torch.parallel.multihost import make_mesh

    count = torch.cuda.device_count()
    devs = [torch.device("cuda", i) for i in range(k)] if count >= k else [torch.device("cuda", 0)] * k
    return make_mesh(devices=devs)


# the four-step NTT's size, and each MSM body's points and shards
SHARD_NTT_N = 1 << 16
SHARD_MSM_BODIES = (("point", 1 << 16, 4), ("window_block", 1 << 12, 4), ("ladder", 1 << 12, 8))
# the kernels the mesh prove must launch.  Not kernel 3(b): the four-step
# row and column transforms of the prove's 2^12-2^17-point NTTs have
# 2^6-2^9 points, inside one block of kernel 3(a) (2^10)
SHARD_KERNELS = ("field_binop", "field_inv", "ntt_block_stages", "g1_add", "bucket_fold", "combine_windows")


def phase_sharded(torch, np, state: dict) -> dict:
    """Phase `sharded`: the 2^14 prove under a mesh of four shards, with
    main's bytes and every shard kernel launched (kernels 1, 2, 3(a), 4, 5
    and 6; no 3(b), see SHARD_KERNELS); one steady single-device and one sharded prove; a 2^16
    four-step NTT (both variants, forward and inverse) and the MSM bodies —
    point shards (2^16 over 4), window blocks (2^12 over 4), the ladder
    (2^12 over 8) — against the single-device results."""
    from marlin_tpu_torch.ops import cuda, fr, msm, ntt
    from marlin_tpu_torch.ops import curve_device as cd
    from marlin_tpu_torch.parallel import msm_sharded, ntt_sharded
    from marlin_tpu_torch.parallel.multihost import axis_devices
    from marlin_tpu_torch.snark.data_structures import Proof
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.utils.rand import ZkRng

    mesh = mesh_of(torch, 4)
    rec = {"mesh": [str(d) for d in axis_devices(mesh, None)]}
    pk, circ = state["pk"], state["circ"]
    reruns = []
    exact = msm.msm_pippenger

    def counting_exact(*args, **kwargs):  # a spill's or a fold flag's exact rerun
        reruns.append(bool(kwargs.get("exact")))
        return exact(*args, **kwargs)

    def prove(sharded: bool):
        rng = copy.deepcopy(state["rng"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            proof = Marlin.prove(pk, circ, rng, device=DEV, mesh=mesh if sharded else None)
        torch.cuda.synchronize()
        return proof.to_bytes(), time.perf_counter() - t

    torch.cuda.synchronize()
    cuda.reset_launches()
    msm.msm_pippenger = counting_exact
    try:
        with counted_msm_calls() as seen, watched_transforms() as watched:
            blob, rec["first_prove_s"] = prove(sharded=True)
    finally:
        msm.msm_pippenger = exact
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    shapes = sorted({tuple(t["shape"]) for t in watched["transforms"]})
    rec.update(launches=launches, transform_shapes=[list(s) for s in shapes], msm_jobs=seen["jobs"],
               host_msm_calls=seen["host_calls"], exact_reruns=sum(reruns), classic_jobs=len(reruns) - sum(reruns))
    require(blob == state["proof"], "sharded: the mesh prove's bytes differ from main's")
    require(Marlin.verify(state["vk"], state["public"], Proof.from_bytes(blob), copy.deepcopy(state["rng"]),
                          device=DEV), "sharded: the mesh proof does not verify")
    for k in SHARD_KERNELS:
        require(launches[k] > 0, f"sharded: kernel {k} was not launched by the mesh prove")
    require(seen["host_calls"] == 0, f"sharded: {seen['host_calls']} host MSM calls")
    require(any(s[-1] == 1 << 7 for s in shapes) and any(s[-1] == 1 << 8 for s in shapes),
            f"sharded: no transform at the four-step shapes of 2^14 and 2^16: {shapes}")
    steady = {"sharded": [], "single": []}
    for sharded in (False, True):
        b, secs = prove(sharded)
        require(b == state["proof"], "sharded: a steady prove's bytes differ")
        steady["sharded" if sharded else "single"].append(secs)
    rec["steady_prove_s"] = steady

    # the four-step NTT at 2^16 against the single-device transform
    n = SHARD_NTT_N
    x = fr.from_canonical_limbs(ZkRng(300).rand_fr_limbs(n), DEV)
    ntts = {}
    for inverse in (False, True):
        want = ntt.transform(x, inverse)
        for name, fn in (("4step", ntt_sharded.ntt_4step), ("resident", ntt_sharded.ntt_4step_resident)):
            cuda.reset_launches()
            got = fn(x, mesh, inverse=inverse)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"sharded: the {name} NTT (inverse={inverse}) differs")
            ntts[f"{name}_{'inv' if inverse else 'fwd'}"] = {
                "launches": {k: v for k, v in cuda.LAUNCHES.items() if v},
                "ms": time_ms(torch, lambda: fn(x, mesh, inverse=inverse), reps=5, warmup=1)}
        ntts[f"single_{'inv' if inverse else 'fwd'}_ms"] = time_ms(torch, lambda: ntt.transform(x, inverse),
                                                                   reps=5, warmup=1)
    rec[f"ntt_{n}"] = ntts

    # the three MSM bodies against the single-device MSM on the SRS powers
    powers = pk.committer_key.pp.powers_of_g
    bodies = {}
    for body, size, k in SHARD_MSM_BODIES:
        pts = tuple(c[:size] for c in powers)
        s = fr.from_canonical_limbs(ZkRng(400 + k + size).rand_fr_limbs(size), DEV)
        m = mesh if k == 4 else mesh_of(torch, k)
        want = cd.to_affine_ints(msm.msm(pts, s))
        cuda.reset_launches()
        got, spill = msm_sharded.msm_sharded_core(pts, s, m)
        torch.cuda.synchronize()
        bl = {kk: v for kk, v in cuda.LAUNCHES.items() if v}
        require(int(spill) == 0, f"sharded: the {body} body spilled {int(spill)}")
        require(cd.to_affine_ints(got) == want, f"sharded: the {body} body differs from the single-device MSM")
        kernel = "g1_scalar_mul" if body == "ladder" else "bucket_fold"
        require(bl.get(kernel, 0) > 0, f"sharded: the {body} body launched no {kernel}: {bl}")
        bodies[body] = {"n": size, "shards": k, "launches": bl,
                        "ms": time_ms(torch, lambda: msm_sharded.msm_sharded_core(pts, s, m), reps=3, warmup=1),
                        "single_ms": time_ms(torch, lambda: msm.msm(pts, s), reps=3, warmup=1)}
    rec["msm_bodies"] = bodies
    rec.update(bytes_equal=True, verifies=True)
    return rec


# --------------------------------------------------------------------------
# phase distributed: the mesh across processes.  DIST_WORLD rank processes
# (`--dist-rank`), each of DIST_SHARDS shards, so the mesh is dcn x ici =
# DIST_WORLD x DIST_SHARDS, the four shards of phase sharded.  They meet on
# a file store under DIST_DIR and read main's keys from phase serial's
# archives and main's circuit and rng state from DIST_DIR/spec.json.
DIST_WORLD = 2
DIST_SHARDS = 2
DIST_TIMEOUT_S = 300  # the ranks' process-group timeout: a dead rank makes the other raise
DIST_LIMIT_S = 600  # the phase's limit on the rank processes
DIST_DIR = os.path.join(SMOKE_DIR, "distributed")


def dist_layout(count: int) -> list:
    """Each rank's devices on a machine of `count` cards: four or more, rank
    r holds cards 2r and 2r+1; two or three, card r twice; one, both ranks
    hold card 0 twice (then the layout takes gloo, `backend_for`)."""
    if count >= DIST_WORLD * DIST_SHARDS:
        return [[f"cuda:{DIST_SHARDS * r + i}" for i in range(DIST_SHARDS)] for r in range(DIST_WORLD)]
    if count >= DIST_WORLD:
        return [[f"cuda:{r}"] * DIST_SHARDS for r in range(DIST_WORLD)]
    return [["cuda:0"] * DIST_SHARDS for _ in range(DIST_WORLD)]


def _wait_ranks(procs: list, limit_s: float) -> list:
    """Wait for every rank process; once one fails or the limit passes, kill
    the others -> their return codes."""
    deadline = time.monotonic() + limit_s
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(p.returncode not in (None, 0) for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            break
        time.sleep(0.2)
    return [p.returncode for p in procs]


def phase_distributed(torch, state: dict, sharded_rec: dict) -> dict:
    """Phase `distributed`: the 2^14 prove over a mesh spanning DIST_WORLD
    processes.  Each rank proves from phase serial's archives and main's rng
    state with main's bytes (which main's verifier key accepts), launching
    every kernel of SHARD_KERNELS and no host MSM, and holds the 2^16
    four-step NTTs and the three MSM bodies across the ranks against its
    own single-device results (`dist_rank_main`).  The backend is the
    layout's (`multihost.backend_for`)."""
    import socket

    from marlin_tpu_torch.parallel.multihost import backend_for
    from marlin_tpu_torch.snark.data_structures import Proof
    from marlin_tpu_torch.snark.marlin import Marlin

    t0 = time.perf_counter()
    os.makedirs(DIST_DIR, exist_ok=True)
    for name in os.listdir(DIST_DIR):
        os.remove(os.path.join(DIST_DIR, name))
    layout = dist_layout(torch.cuda.device_count())
    spec = {"layout": layout, "store": os.path.join(DIST_DIR, "store"), "log2": MAIN_LOG2,
            "a": state["circ"].a, "b": state["circ"].b, "rng_state": state["rng"]._gen.bit_generator.state}
    with open(os.path.join(DIST_DIR, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, MARLIN_TPU_CURVE="bls12_381")
    procs, logs = [], []
    for r in range(DIST_WORLD):
        logs.append(open(os.path.join(DIST_DIR, f"rank{r}.log"), "w"))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
                                       "--out", os.path.join(DIST_DIR, f"rank{r}.json")],
                                      cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        rcs = _wait_ranks(procs, DIST_LIMIT_S)
    finally:
        for f in logs:
            f.close()
    ranks = []
    for r, rc in enumerate(rcs):
        path = os.path.join(DIST_DIR, f"rank{r}.json")
        rank_rec = json.load(open(path)) if os.path.exists(path) else {}
        if rc != 0:
            log = open(os.path.join(DIST_DIR, f"rank{r}.log")).read()
            require(False, f"distributed: rank {r} failed (rc {rc}): {rank_rec.get('error')}\n{log[-3000:]}")
        ranks.append(rank_rec)
    want_backend = backend_for([(socket.gethostname(), devs) for devs in layout])
    for r, rr in enumerate(ranks):
        require(bytes.fromhex(rr["proof"]) == state["proof"], f"distributed: rank {r}'s proof differs from main's")
        require(Marlin.verify(state["vk"], state["public"], Proof.from_bytes(bytes.fromhex(rr["proof"])),
                              copy.deepcopy(state["rng"]), device=DEV),
                f"distributed: main's verifier key rejects rank {r}'s proof")
        require(rr["steady_equal"], f"distributed: rank {r}'s steady prove differs from its first")
        for k in SHARD_KERNELS:
            require(rr["launches"].get(k, 0) > 0, f"distributed: rank {r} launched no {k} in its prove")
        require(rr["host_msm_calls"] == 0, f"distributed: rank {r} called the host MSM {rr['host_msm_calls']} times")
        require(all(v["equal"] for v in rr["ntt"].values()), f"distributed: rank {r}'s NTTs differ: {rr['ntt']}")
        require(all(v["equal"] and v["spill"] == 0 for v in rr["msm_bodies"].values()),
                f"distributed: rank {r}'s MSM bodies differ: {rr['msm_bodies']}")
        require(rr["backend"] == want_backend, f"distributed: rank {r} ran {rr['backend']}, the layout takes "
                f"{want_backend}")
    rec = {"layout": layout, "backend": ranks[0]["backend"], "exchange": ranks[0]["route"],
           "devices": [rr["devices"] for rr in ranks], "mesh": ranks[0]["mesh"],
           "prove_s": [{"first": rr["first_prove_s"], "steady": rr["steady_prove_s"]} for rr in ranks],
           "one_process_sharded_steady_s": sharded_rec["steady_prove_s"]["sharded"],
           "single_device_steady_s": sharded_rec["steady_prove_s"]["single"],
           "prove_exchanges": [rr["prove_exchanges"] for rr in ranks],
           "prove_launches": [rr["launches"] for rr in ranks],
           "exact_reruns": [rr["exact_reruns"] for rr in ranks],
           "ntt": ranks[0]["ntt"], "msm_bodies": ranks[0]["msm_bodies"],
           "rank_s": [rr["seconds"] for rr in ranks], "bytes_equal": True, "verifies": True}
    rec["seconds"] = time.perf_counter() - t0
    return rec


def dist_rank_main(rank: int, out: str) -> int:
    """`--dist-rank R --out PATH`: rank R of phase distributed, its record
    to PATH."""
    import datetime

    import torch

    spec = json.load(open(os.path.join(DIST_DIR, "spec.json")))
    rec = {"rank": rank}
    t0 = time.perf_counter()
    try:
        from marlin_tpu_torch.ops import cuda, fr, msm, ntt
        from marlin_tpu_torch.ops import curve_device as cd
        from marlin_tpu_torch.parallel import collectives, msm_sharded, multihost, ntt_sharded
        from marlin_tpu_torch.parallel.multihost import axis_devices
        from marlin_tpu_torch.snark import serial
        from marlin_tpu_torch.snark.marlin import Marlin
        from marlin_tpu_torch.utils.rand import ZkRng

        require(torch.cuda.is_available(), "no CUDA device")
        devices = [torch.device(d) for d in spec["layout"][rank]]
        home = devices[0]
        torch.cuda.set_device(home)
        cuda.build()  # the library the parent's build phase made
        multihost.init_distributed(devices=devices, init_method=f"file://{spec['store']}", rank=rank,
                                   world_size=DIST_WORLD, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        mesh = multihost.make_mesh()
        rec.update(devices=[str(d) for d in devices], backend=multihost.backend(),
                   mesh=[str(d) for d in mesh.devices.flat], mesh_ranks=mesh.ranks.tolist())
        d = os.path.join(SMOKE_DIR, "serial_bls12_381")
        srs = serial.load_srs(os.path.join(d, "srs.npz"), device=home)
        pk = serial.load_index_pk(os.path.join(d, "lean.npz"), srs=srs, device=home)
        circ = DummyCircuit(spec["a"], spec["b"], num_variables=10, num_constraints=1 << spec["log2"])

        def prove():
            rng = ZkRng(0)
            rng._gen.bit_generator.state = spec["rng_state"]  # main's state at its prove
            torch.cuda.synchronize()
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                proof = Marlin.prove(pk, circ, rng, device=home, mesh=mesh)
            torch.cuda.synchronize()
            return proof.to_bytes().hex(), time.perf_counter() - t

        reruns = []
        exact = msm.msm_pippenger

        def counting_exact(*args, **kwargs):
            reruns.append(bool(kwargs.get("exact")))
            return exact(*args, **kwargs)

        cuda.reset_launches()
        collectives.reset_exchanges()
        msm.msm_pippenger = counting_exact
        try:
            with counted_msm_calls() as seen:
                blob, rec["first_prove_s"] = prove()
        finally:
            msm.msm_pippenger = exact
        torch.cuda.synchronize()
        rec.update(proof=blob, launches={k: v for k, v in cuda.LAUNCHES.items() if v},
                   prove_exchanges=dict(collectives.EXCHANGES), host_msm_calls=seen["host_calls"],
                   exact_reruns=sum(reruns))
        blob2, rec["steady_prove_s"] = prove()
        rec["steady_equal"] = blob2 == blob

        n = SHARD_NTT_N
        x = fr.from_canonical_limbs(ZkRng(300).rand_fr_limbs(n), home)
        rec["route"] = collectives.route(x)
        ntts = {}
        for inverse in (False, True):
            want = ntt.transform(x, inverse)
            for name, fn in (("4step", ntt_sharded.ntt_4step), ("resident", ntt_sharded.ntt_4step_resident)):
                got = fn(x, mesh, inverse=inverse)
                ntts[f"{name}_{'inv' if inverse else 'fwd'}"] = {
                    "equal": bool(torch.equal(got, want)),
                    "ms": time_ms(torch, lambda: fn(x, mesh, inverse=inverse), reps=5, warmup=1)}
        rec["ntt"] = ntts

        powers = pk.committer_key.pp.powers_of_g
        bodies = {}
        for body, size, k in SHARD_MSM_BODIES:
            # a mesh of k shards: each rank holds its card k / DIST_WORLD times (every rank calls make_mesh)
            m = mesh if k == DIST_WORLD * DIST_SHARDS else multihost.make_mesh(devices=[home] * (k // DIST_WORLD))
            pts = tuple(c[:size] for c in powers)
            s = fr.from_canonical_limbs(ZkRng(400 + k + size).rand_fr_limbs(size), home)
            want = cd.to_affine_ints(msm.msm(pts, s))
            got, spill = msm_sharded.msm_sharded_core(pts, s, m)
            bodies[body] = {"n": size, "shards": len(axis_devices(m, None)), "equal": cd.to_affine_ints(got) == want,
                            "spill": int(spill),
                            "ms": time_ms(torch, lambda: msm_sharded.msm_sharded_core(pts, s, m), reps=3, warmup=1)}
        rec["msm_bodies"] = bodies
        rec["exchanges"] = dict(collectives.EXCHANGES)
        multihost.shutdown()
    except Exception as e:
        import traceback

        traceback.print_exc()
        rec["error"] = f"{type(e).__name__}: {e}"
    finally:
        rec["seconds"] = time.perf_counter() - t0
        _write(out, rec)
    return 1 if "error" in rec else 0


# --------------------------------------------------------------------------
# the other curves.  The curve is chosen once a process (MARLIN_TPU_CURVE,
# fields/active.py), so each runs in a process of its own: `--curve NAME`
# runs that curve's phases, `--cpu-proof` its CPU reference proof.  The
# parent (BLS12-381) builds every curve's library in its build phase,
# starts the CPU reference proofs beside its own phases, and runs each
# curve's process after them.
#
# log2: the constraints of the curve's main path (setup on the card, index,
# prove, verify, the classic route's proof); cpu_log2: the prove held
# against the CPU's proof bytes (for BLS12-377 the main path's own); cap: MARLIN_TPU_FR_TWO_ADICITY_CAP for that
# comparison, low enough that every domain of it is mixed-radix; sonic_log2:
# a MarlinSonic prove on the card.
CURVES = {
    "bn254": {"log2": 14, "cpu_log2": 10, "cap": None, "sonic_log2": 11},
    "synthetic_lowadic": {"log2": 14, "cpu_log2": 11, "cap": 10, "sonic_log2": None},
    "bls12_377": {"log2": 11, "cpu_log2": 11, "cap": None, "sonic_log2": None},
    # a field with no curve: its AHP alone (WIDE_KERNELS), the CPU's at 2^6
    # under a 2-adicity cap of 5 (|H| = 72, |K| = 216, both mixed)
    "test_wide750": {"log2": 14, "cpu_log2": 6, "cap": 5, "sonic_log2": None},
}
WIDE = "test_wide750"
WIDE_KERNELS = ("field_binop", "field_inv", "ntt_block_stages", "ntt_cross_stage")
# synthetic_lowadic's mixed transforms at n1 = 3, 9 and 27 beside the prove's
MIXED_EXTRA_SHAPES = ((3 << 11,), (9 << 11,), (27 << 11,))


@contextlib.contextmanager
def two_adicity_cap(cap):
    """MARLIN_TPU_FR_TWO_ADICITY_CAP = cap (None: as it is) for the block:
    the domains of a prove and of its verify are chosen under it."""
    old = os.environ.get("MARLIN_TPU_FR_TWO_ADICITY_CAP")
    if cap is not None:
        os.environ["MARLIN_TPU_FR_TWO_ADICITY_CAP"] = str(cap)
    try:
        yield
    finally:
        if cap is not None:
            if old is None:
                os.environ.pop("MARLIN_TPU_FR_TWO_ADICITY_CAP")
            else:
                os.environ["MARLIN_TPU_FR_TWO_ADICITY_CAP"] = old


def prove_bytes_on(device, log2: int):
    """Marlin on DummyCircuit(2^log2) from a fresh test_rng(): setup
    (n, n, 3n), index, prove on `device` -> (proof bytes, vk, public input,
    rng after the prove, index key)."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.utils.rand import test_rng

    n = 1 << log2
    rng = test_rng()
    a, b = rng.rand_fr(), rng.rand_fr()
    circ = DummyCircuit(a, b, num_variables=10, num_constraints=n)
    srs = Marlin.universal_setup(n, n, 3 * n, rng, device=device)
    pk, vk = Marlin.index(srs, circ, device=device)
    with contextlib.redirect_stdout(io.StringIO()):
        proof = Marlin.prove(pk, circ, rng, device=device)
    return proof.to_bytes(), vk, [a * b % P.R_MODULUS], rng, pk


def cpu_proof_main(curve: str, out: str) -> int:
    """`--cpu-proof CURVE --out PATH`: the curve's reference proof on the
    CPU (plain versions, the host MSM), its bytes as hex to PATH."""
    if curve == WIDE:
        return cpu_ahp_main(curve, out)
    import torch

    torch.set_num_threads(2)
    cfg = CURVES[curve]
    t = time.perf_counter()
    with two_adicity_cap(cfg["cap"]):
        proof, *_ = prove_bytes_on("cpu", cfg["cpu_log2"])
    _write(out, {"curve": curve, "log2": cfg["cpu_log2"], "cap": cfg["cap"], "proof": proof.hex(),
                 "seconds": time.perf_counter() - t})
    return 0


def start_cpu_proofs() -> dict:
    """Start every curve's CPU reference proof in a process of its own."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    procs = {}
    for curve in CURVES:
        out = os.path.join(SMOKE_DIR, f"cpu_proof_{curve}.json")
        if os.path.exists(out):
            os.remove(out)
        env = dict(os.environ, MARLIN_TPU_CURVE=curve)
        env.pop("MARLIN_TPU_FR_TWO_ADICITY_CAP", None)
        procs[curve] = (subprocess.Popen([sys.executable, os.path.abspath(__file__), "--cpu-proof", curve,
                                          "--out", out], cwd=ROOT, env=env,
                                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    return procs


# test_wide750: the AHP's transcript label (tests/test_wide750.py), and the
# mixed transform at n1 = 81 and the field's largest radix-2 size beside the
# AHP's own shapes
WIDE_LABEL = b"MARLIN-2019-wide750"
WIDE_EXTRA_SHAPES = ((81 << 9,), (1 << 13,))


def digest(t) -> str:
    """sha256 of a limb tensor's int32 words, with its shape."""
    import hashlib

    arr = t.detach().cpu().numpy().astype("<i4")
    return f"{list(arr.shape)}:{hashlib.sha256(arr.tobytes()).hexdigest()}"


def ahp_circuit(log2: int) -> tuple:
    """(the zk rng, DummyCircuit(10 variables, 2^log2 constraints)) of the
    AHP run: both from a fresh test_rng()."""
    from marlin_tpu_torch.utils.rand import test_rng

    rng = test_rng()
    a, b = rng.rand_fr(), rng.rand_fr()
    return rng, DummyCircuit(a, b, num_variables=10, num_constraints=1 << log2)


def run_ahp(torch, device, log2: int, watch: bool = False, index=None) -> dict:
    """The AHP of a field with no curve on `device`, as tests/test_wide750.py
    drives it (the JAX package has no PC layer and no `Marlin` for such a
    field): index_circuit(DummyCircuit(10 variables, 2^log2 constraints))
    unless `index` is that circuit's index already, prover_init, the three
    prover rounds with the verifier's rounds between them on
    FiatShamirRng(WIDE_LABEL + the index info), the query set and the linear
    combinations.  -> |H|, |K|, the seconds of the index and of each step,
    the two zero-eval combinations' values, the challenges, a digest of
    every oracle's limbs, the mixed transforms by device and, with `watch`,
    the rounds' transforms and inversions."""
    from marlin_tpu_torch.ops import ntt
    from marlin_tpu_torch.snark import ahp, lc as lc_mod, prover as prover_mod, verifier as verifier_mod
    from marlin_tpu_torch.snark.fs import FiatShamirRng
    from marlin_tpu_torch.snark.indexer import index_circuit

    rec = {"num_constraints": 1 << log2}

    def timed(name, fn):
        if device != "cpu":
            torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        rec[f"{name}_s"] = time.perf_counter() - t
        return res

    mixed_before = dict(ntt.MIXED_TRANSFORMS)
    rng, circ = ahp_circuit(log2)
    idx = index if index is not None else timed("index", lambda: index_circuit(circ, device))
    state = timed("init", lambda: prover_mod.prover_init(idx, circ))
    public_input = state.public_input()
    fs = FiatShamirRng(WIDE_LABEL + idx.index_info.to_bytes())
    with watched_transforms() if watch else contextlib.nullcontext({}) as watched:
        first, state = timed("round1", lambda: prover_mod.prover_first_round(state, rng))
        v1, vs = verifier_mod.verifier_first_round(idx.index_info, fs)
        second, state = timed("round2", lambda: prover_mod.prover_second_round(v1, state, rng))
        v2, vs = verifier_mod.verifier_second_round(vs, fs)
        third = timed("round3", lambda: prover_mod.prover_third_round(v2, state, rng))
        vs = verifier_mod.verifier_third_round(vs, fs)
    oracles = {**first, **second, **third}
    polys = {label: prover_mod.LabeledPoly(label, coeffs, bound, None) for label, coeffs, bound in idx.iter_polys()}
    polys.update(oracles)

    def zero_evals():
        query_set, _ = verifier_mod.verifier_query_set(vs)
        provider = lc_mod.PolyEvaluationsProvider(polys)
        lcs = lc_mod.construct_linear_combinations(public_input, provider, vs)
        return {label: int(provider.get_lc_eval(next(c for c in lcs if c.label == label), point))
                for label, (_pl, point) in query_set if label in ahp.LC_WITH_ZERO_EVAL}

    rec["zero_evals"] = timed("lincheck", zero_evals)
    rec.update(H=idx.domain_h.size, K=idx.domain_k.size,
               challenges=[str(v) for v in (v1.alpha, v1.eta_a, v1.eta_b, v1.eta_c, v2.beta, vs.gamma)],
               oracles={k: digest(v.coeffs) for k, v in sorted(oracles.items())},
               mixed_transforms={k: v - mixed_before[k] for k, v in ntt.MIXED_TRANSFORMS.items()})
    if watch:
        rec.update(transforms=watched["transforms"], inversions=watched["inversions"])
    return rec


def cpu_ahp_main(curve: str, out: str) -> int:
    """`--cpu-proof CURVE --out PATH` for a field with no curve: its AHP at
    2^cpu_log2 on the CPU (plain versions) under the capped 2-adicity, its
    record (challenges and oracle digests) to PATH."""
    import torch

    torch.set_num_threads(2)
    cfg = CURVES[curve]
    t = time.perf_counter()
    with two_adicity_cap(cfg["cap"]):
        rec = run_ahp(torch, "cpu", cfg["cpu_log2"])
    _write(out, {"curve": curve, "log2": cfg["cpu_log2"], "cap": cfg["cap"], "ahp": rec,
                 "seconds": time.perf_counter() - t})
    return 0


def wide_main(torch) -> dict:
    """The AHP at 2^14 on the card: |H| = 18,432 and |K| = 55,296, both
    mixed; both sumcheck combinations 0; every mixed transform on the card,
    each in its kernels (one 3(a) launch for its inner transforms, one 3(b)
    per group of stages past the block, the twiddle, the small DFT's product and
    modsum's two products, no gather op); each inversion in one launch; the
    four kernels launched."""
    from marlin_tpu_torch.ops import cuda

    cfg = CURVES[WIDE]
    torch.cuda.synchronize()
    cuda.reset_launches()
    rec = run_ahp(torch, DEV, cfg["log2"], watch=True)
    torch.cuda.synchronize()
    rec["launches"] = {k: cuda.LAUNCHES[k] for k in WIDE_KERNELS}
    rec["binop_launches"] = {f"{f}.{op}": v for (f, op), v in sorted(cuda.BINOP_LAUNCHES.items())}
    rec["binop_copies"] = dict(cuda.BINOP_COPIES)
    require((rec["H"], rec["K"]) == (18432, 55296), f"{WIDE}: domains {rec['H']}, {rec['K']}")
    require(rec["binop_copies"]["broadcast"] == 0, f"{WIDE}: materialized broadcasts: {rec['binop_copies']}")
    require(rec["zero_evals"] == {"inner_sumcheck": 0, "outer_sumcheck": 0},
            f"{WIDE}: the sumcheck combinations are {rec['zero_evals']}")
    mixed = rec["mixed_transforms"]
    require(mixed["cuda"] > 0 and mixed["cpu"] == 0, f"{WIDE}: mixed transforms {mixed}")
    for name, v in rec["launches"].items():
        require(v > 0, f"{WIDE}: kernel {name} was not launched on the main path")
    require_transforms_in_kernels(torch, WIDE, rec["transforms"])
    require(all(i["launches"] == 1 for i in rec["inversions"]), f"{WIDE}: inversions {rec['inversions']}")
    return rec


def wide_kernels(torch, np, main_rec: dict) -> dict:
    """test_wide750's kernel rows, each against its plain version on the
    card: the binop at |K| and 2^16 (mul, add, sub, and mul with an operand
    below R), the inversion at the AHP's sizes and at one element, the NTT
    at the AHP's transform shapes and at WIDE_EXTRA_SHAPES, and mont_mul."""
    global FR_N, INV_SHAPES, NTT_PROVE_SHAPES, FR_BYTES
    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import fr, mont

    FR_BYTES = 4 * fr.L
    FR_N = main_rec["K"]
    INV_SHAPES = tuple(("fr", n) for n in sorted({i["n"] for i in main_rec["inversions"]} | {1}, reverse=True))
    shapes = sorted({tuple(t["shape"]) for t in main_rec["transforms"] if t["shape"][-1] >= 1 << 10} | {(FR_N,)},
                    key=lambda sh: (sh[-1], sh))
    NTT_PROVE_SHAPES = tuple(shapes + [sh for sh in WIDE_EXTRA_SHAPES if sh not in shapes])
    rng = np.random.default_rng(750)
    dev = torch.device(DEV)
    results = {}

    def err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    results["field_binop"] = binop_rows(torch, np, rng, err, (fr.CTX,), sorted({1 << 14, 1 << 16, FR_N}))
    results["field_inv"] = inversion_row(torch, np, rng, err)
    results.update(ntt_rows(torch, np, rng, err))
    results["ntt_block_stages"]["block_plan"] = block_plan(torch, np, rng)
    ma = torch.as_tensor(random_elements(np, rng, fr.CTX, MONT_N), device=dev)
    mb = torch.as_tensor(random_elements(np, rng, fr.CTX, MONT_N), device=dev)
    b_ms, b_by = bound(3 * MONT_N * FR_BYTES, product_ops("fr", MONT_N))
    results["mont_mul"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/field.cu",
        "replaces": "marlin_tpu/ops/pallas/mont.py:83",
        "max_abs_err": err(mont.mont_mul(ma, mb), bi.mont_mul(fr.CTX, ma, mb)), "shape": f"[{MONT_N}, {fr.L}]",
        "ms": time_ms(torch, lambda: mont.mont_mul(ma, mb)),
        "device_ms": device_times(torch, {"mont_mul": (lambda: mont.mont_mul(ma, mb), "binop_", 1)})["mont_mul"],
        "plain_ms": time_ms(torch, lambda: bi.mont_mul(fr.CTX, ma, mb), reps=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    torch.cuda.synchronize()
    for name, r in results.items():
        require(r["max_abs_err"] == 0, f"{WIDE}: {name} disagrees with its plain version: {r}")
    return results


def block_plan(torch, np, rng) -> list:
    """Kernel 3's stages of the AHP's inner transforms (2^11 points, 9 and
    27 of them at |H| and |K|), forward and inverse, with 3(a)'s block at
    2^9 and at 2^10 (3(b) launches for the stages past it): the milliseconds
    of each plan, by which ops/ntt.py picks BLOCK_LOG2 at 24 words."""
    from marlin_tpu_torch.ops import fr, ntt

    dev = torch.device(DEV)
    out = []
    for n in (18432, 55296):
        flat = torch.as_tensor(random_elements(np, rng, fr.CTX, n), device=dev)
        for inverse in (False, True):
            log_n, tw, scale = stage_plan(ntt, n, inverse, dev)
            row = {"n": n, "inner": 1 << log_n, "inverse": inverse}
            for log_b in (9, 10):
                row[f"block_2^{log_b}_ms"] = time_ms(
                    torch, lambda: ntt._radix2_stages(flat, log_n, tw, scale, False, log_b))
            out.append(row)
    return out


def wide_cpu_check(torch, cpu_file: str) -> dict:
    """The card's AHP at the CPU process's size and cap against its record:
    the same domains (both mixed), challenges and oracle limbs, with no
    mixed transform on the host."""
    cfg = CURVES[WIDE]
    ref = json.load(open(cpu_file))
    require(ref["curve"] == WIDE and ref["log2"] == cfg["cpu_log2"], f"{WIDE}: the CPU reference is {ref}")
    with two_adicity_cap(cfg["cap"]):
        card = run_ahp(torch, DEV, cfg["cpu_log2"])
    cpu = ref["ahp"]
    rec = {"cpu_log2": cfg["cpu_log2"], "cap": cfg["cap"], "cpu_s": ref["seconds"], "H": card["H"], "K": card["K"],
           "card_s": sum(v for k, v in card.items() if k.endswith("_s"))}
    require(card["H"] & (card["H"] - 1) and card["K"] & (card["K"] - 1), f"{WIDE}: {card['H']}, {card['K']} not mixed")
    require(card["mixed_transforms"]["cpu"] == 0, f"{WIDE}: a mixed transform ran on the host")
    require((card["H"], card["K"]) == (cpu["H"], cpu["K"]), f"{WIDE}: domains differ from the CPU's")
    require(card["challenges"] == cpu["challenges"], f"{WIDE}: the card's challenges differ from the CPU's")
    require(card["oracles"] == cpu["oracles"], f"{WIDE}: the card's oracles differ from the CPU's")
    require(card["zero_evals"] == cpu["zero_evals"] == {"inner_sumcheck": 0, "outer_sumcheck": 0},
            f"{WIDE}: zero evals {card['zero_evals']}, {cpu['zero_evals']}")
    rec.update(challenges_equal=True, oracles_equal=len(card["oracles"]))
    return rec


def wide_process_main(cpu_file: str, out: str) -> int:
    """`--curve test_wide750 --cpu-proof-file PATH --out PATH`: the phases of
    the field with no curve in this process (build check, main, kernels,
    cpu), each printing one JSON line; the kernel rows and every record to
    PATH."""
    import numpy as np
    import torch

    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import cuda, fr

    phase = "build"
    try:
        require(P.CURVE_NAME == WIDE, f"MARLIN_TPU_CURVE gives {P.CURVE_NAME}, expected {WIDE}")
        global PEAK_OPS_PER_S
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import imad_rate
        import sass_count

        secs = cuda.build()
        lib = cuda.lib()
        require(lib.marlin_curve_id().decode() == WIDE, "the library names another curve")
        # the field and NTT kernels only; an Fq call is refused
        require(not any(hasattr(lib, n) for n in ("marlin_g1_add", "marlin_bucket_fold", "marlin_g1_scalar_mul")),
                f"{WIDE}: the library holds a group kernel")
        fq_ctx = bi.ModCtx("fq", fr.CTX.modulus, fr.L, WIDE)
        x = torch.ones((4, fr.L), dtype=torch.int32, device=DEV)
        for call in (lambda: bi.binop_kernel("mul", fq_ctx, x, x), lambda: bi.inv_kernel(fq_ctx, x)):
            try:
                call()
                refused = False
            except RuntimeError:
                refused = True
            require(refused, f"{WIDE}: an Fq call was not refused")
        reports = {src: ptxas_report(os.path.join(cuda.build_dir(), src + ".ptxas.txt")) for src in cuda.sources(WIDE)}
        ptxas = {}
        for label, (src, frag) in ptxas_kernels(WIDE).items():
            hits = [v for k, v in reports[src].items() if frag in k and "registers" in v]
            require(len(hits) == 1, f"ptxas: {len(hits)} reports for {label} ({WIDE})")
            require(hits[0].get("spill_stores", 0) == 0 and hits[0].get("spill_loads", 0) == 0,
                    f"ptxas: {label} spills ({WIDE}): {hits[0]}")
            ptxas[label] = hits[0]
        sass = sass_count.count(cuda.lib_path())
        MULS_PER_PRODUCT["fr"] = sass["product"]["fr"]["multiplies"]
        PEAK_OPS_PER_S = integer_peak(torch)["ops_per_s"]
        emit({"phase": "build", "curve": WIDE, "seconds": secs, "ptxas": ptxas, "product_sass": sass["product"],
              "kernel_sass": sass["kernels"], "product_latency": {"fr": imad_rate.product_latency(torch, "fr")}})

        phase = "main"
        main_rec = wide_main(torch)
        emit({"phase": "main", "curve": WIDE, **main_rec})

        phase = "kernels"
        kernels = wide_kernels(torch, np, main_rec)
        emit({"phase": "kernels", "curve": WIDE, "results": kernels})

        phase = "cpu"
        emit({"phase": "cpu", "curve": WIDE, **wide_cpu_check(torch, cpu_file)})
    except Exception as e:
        import traceback

        traceback.print_exc()
        print(json.dumps({"phase": phase, "curve": WIDE, "error": f"{type(e).__name__}: {e}"}), flush=True)
        _write(out, {"records": RECORDS, "failed_phase": phase, "error": str(e)})
        return 1
    _write(out, {"records": RECORDS, "kernels": curve_kernel_rows(WIDE, main_rec, kernels)})
    return 0


def set_curve_shapes(log2: int, K: int, inversions: list, transforms: list, jobs: list,
                     n_powers: int) -> None:
    """The kernel rows' shapes for the active curve, from its main path: the
    NTT shapes and the inversions its prove ran, the largest MSM jobs of its
    prove (the table fold), its SRS's powers (add, double and the table
    build's Fq normalization)."""
    global FR_N, FQ_N, INV_SHAPES, NTT_PROVE_SHAPES, CURVE_N, MAIN_HEAD, FOLD_JOBS, FQ_BYTES
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import fq, msm

    FQ_BYTES = 4 * fq.L
    FR_N, FQ_N = K, 1 << min(log2, 14)
    c = msm._fixed_c(n_powers)
    fr_sizes = sorted({i["n"] for i in inversions if i["field"] == "fr"}, reverse=True)
    INV_SHAPES = tuple(("fr", n) for n in fr_sizes) + (("fq", (msm.fixed_table_windows(c) - 1) * n_powers),)
    # the prove's transforms of at least 2^10 points (a 2-point domain's are no kernel row)
    shapes = sorted({tuple(t["shape"]) for t in transforms if t["shape"][-1] >= 1 << 10},
                    key=lambda sh: (sh[-1], sh))
    if (K,) not in shapes:
        shapes.append((K,))
    if P.CURVE_NAME == "synthetic_lowadic":
        shapes += [sh for sh in MIXED_EXTRA_SHAPES if sh not in shapes]
    NTT_PROVE_SHAPES = tuple(shapes)
    CURVE_N = n_powers
    MAIN_HEAD = 1 << log2
    # the table fold of the largest size that three jobs share (round 3's)
    sizes = [size for _, size in jobs]
    big = max((size for size in set(sizes) if sizes.count(size) >= 3), default=max(sizes))
    FOLD_JOBS = tuple(j for j in jobs if j[1] == big)[:3]


def require_transforms_in_kernels(torch, curve: str, transforms: list) -> None:
    """Each watched transform ran in its kernels: one 3(a) launch (for a
    mixed size, its inner batch) and one 3(b) per group of stages past the block, no
    gather op; a mixed one also the twiddle, the small DFT's product and
    modsum's two products of Fr, a radix-2 one no Fr product."""
    from marlin_tpu_torch.ops import ntt

    for t in transforms:
        size = t["shape"][-1]
        log_n = stage_plan(ntt, size, False, torch.device(DEV))[0]
        want = (1, len(ntt.cross_groups(log_n, min(log_n, ntt.BLOCK_LOG2))))
        muls = 4 if size & (size - 1) else 0
        require((t["block_launches"], t["cross_launches"]) == want and t["fr_mul_launches"] == muls
                and not set(t["ops"]) & GATHER_OPS, f"{curve}: an NTT ran outside its kernels: {t}")


def curve_main(torch, curve: str) -> tuple:
    """The curve's main path on the card: setup (the G1 powers by kernel 4's
    ladder), index, prove, verify; a wrong input and a flipped byte are
    rejected; the prove calls no host MSM and reruns nothing; on a
    mixed-radix domain every transform runs on the card, its inner
    transforms through kernel 3; then the classic route's proof from the
    same rng state has the same bytes."""
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import cuda, ntt
    from marlin_tpu_torch.snark import kzg
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.utils.rand import test_rng

    cfg = CURVES[curve]
    n = 1 << cfg["log2"]
    rng = test_rng()
    a, b = rng.rand_fr(), rng.rand_fr()
    circ = DummyCircuit(a, b, num_variables=10, num_constraints=n)
    public = [a * b % P.R_MODULUS]
    rec = {"curve": curve, "num_constraints": n}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        rec[f"{name}_s"] = time.perf_counter() - t
        return res

    torch.cuda.synchronize()
    cuda.reset_launches()
    for k in ntt.MIXED_TRANSFORMS:
        ntt.MIXED_TRANSFORMS[k] = 0
    srs = timed("setup", lambda: Marlin.universal_setup(n, n, 3 * n, rng, device=DEV))
    pk, vk = timed("index", lambda: Marlin.index(srs, circ, device=DEV))
    before = dict(cuda.LAUNCHES)
    copies_before = dict(cuda.BINOP_COPIES)
    mixed_before = dict(ntt.MIXED_TRANSFORMS)
    reruns = kzg.STATS["exact_reruns"]
    rng_at_prove = copy.deepcopy(rng)
    with counted_msm_calls() as seen, watched_transforms() as watched, \
            contextlib.redirect_stdout(io.StringIO()):
        proof = timed("prove", lambda: Marlin.prove(pk, circ, rng, device=DEV))
    prove_launches = {k: v - before[k] for k, v in cuda.LAUNCHES.items()}
    prove_copies = {k: v - copies_before[k] for k, v in cuda.BINOP_COPIES.items()}
    mixed = {k: v - mixed_before[k] for k, v in ntt.MIXED_TRANSFORMS.items()}
    ok = timed("verify", lambda: Marlin.verify(vk, public, proof, rng, device=DEV))
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    blob = proof.to_bytes()
    flipped = bytearray(blob)
    flipped[len(flipped) // 2] ^= 0x01
    h, k = pk.index.domain_h.size, pk.index.domain_k.size
    rec.update(H=h, K=k, launches=launches, prove_launches=prove_launches,
               binop_launches={f"{f}.{op}": v for (f, op), v in sorted(cuda.BINOP_LAUNCHES.items())},
               prove_msm_jobs=seen["jobs"], prove_host_msm_calls=seen["host_calls"],
               prove_exact_reruns=kzg.STATS["exact_reruns"] - reruns, prove_inversions=watched["inversions"],
               prove_transforms=watched["transforms"], prove_mixed_transforms=mixed,
               binop_copies=dict(cuda.BINOP_COPIES), prove_binop_copies=prove_copies,
               srs_powers=srs.powers_of_g[0].shape[0], proof_bytes=len(blob), verifies=bool(ok))
    require(ok, f"{curve}: the 2^{cfg['log2']} proof does not verify")
    require(_rejects(Marlin, vk, [(public[0] + 1) % P.R_MODULUS], blob, rng, DEV),
            f"{curve}: a wrong input was accepted")
    require(_rejects(Marlin, vk, public, bytes(flipped), rng, DEV), f"{curve}: a flipped byte was accepted")
    for name, v in launches.items():
        require(v > 0 or name == "combine_windows", f"{curve}: kernel {name} was not launched on the main path")
    require(seen["host_calls"] == 0, f"{curve}: the prove called the host MSM {seen['host_calls']} times")
    require(rec["prove_exact_reruns"] == 0, f"{curve}: the prove reran {rec['prove_exact_reruns']} MSM batches")
    require(mixed["cpu"] == 0, f"{curve}: {mixed['cpu']} mixed-radix transforms ran on the host")
    require(prove_copies["broadcast"] == 0, f"{curve}: the prove materialized broadcasts: {prove_copies}")
    require_transforms_in_kernels(torch, curve, watched["transforms"])
    if h & (h - 1) or k & (k - 1):
        require(mixed["cuda"] > 0, f"{curve}: mixed domains, but no mixed transform on the card")
    # the classic Pippenger from the same rng state: the same bytes
    cuda.reset_launches()
    with classic_route(), counted_msm_calls() as seen_c, contextlib.redirect_stdout(io.StringIO()):
        classic = timed("classic_prove", lambda: Marlin.prove(pk, circ, copy.deepcopy(rng_at_prove), device=DEV))
    torch.cuda.synchronize()
    rec["classic_launches"] = dict(cuda.LAUNCHES)
    require(classic.to_bytes() == blob, f"{curve}: the classic route's proof bytes differ from the table route's")
    require(cuda.LAUNCHES["combine_windows"] == len(seen_c["jobs"]) > 0,
            f"{curve}: {cuda.LAUNCHES['combine_windows']} combines for {len(seen_c['jobs'])} MSM jobs")
    require(seen_c["host_calls"] == 0, f"{curve}: the classic prove called the host MSM")
    rec["classic_bytes_equal"] = True
    state = {"pk": pk, "vk": vk, "proof": blob, "public": public, "watched": watched, "jobs": seen["jobs"],
             "circ": circ, "rng": rng_at_prove}
    return rec, state


def curve_cpu_check(torch, curve: str, state: dict, cpu_proof: str) -> dict:
    """The card's proof against the CPU's reference bytes (`--cpu-proof`),
    on mixed-radix domains for synthetic_lowadic; a MarlinSonic prove."""
    from marlin_tpu_torch.ops import ntt
    from marlin_tpu_torch.snark.marlin import Marlin, MarlinSonic
    from marlin_tpu_torch.utils.rand import test_rng

    cfg = CURVES[curve]
    ref = json.load(open(cpu_proof))
    require(ref["curve"] == curve and ref["log2"] == cfg["cpu_log2"], f"{curve}: the CPU reference is {ref}")
    rec = {"cpu_log2": cfg["cpu_log2"], "cap": cfg["cap"], "cpu_s": ref["seconds"]}
    if cfg["cpu_log2"] == cfg["log2"]:
        card = state["proof"]
    else:
        from marlin_tpu_torch.snark.data_structures import Proof

        before = ntt.MIXED_TRANSFORMS["cpu"]
        with two_adicity_cap(cfg["cap"]):
            t = time.perf_counter()
            card, vk, public, rng, pk = prove_bytes_on(DEV, cfg["cpu_log2"])
            torch.cuda.synchronize()
            rec["card_s"] = time.perf_counter() - t
            ok = Marlin.verify(vk, public, Proof.from_bytes(card), rng, device=DEV)
        h, k = pk.index.domain_h.size, pk.index.domain_k.size
        rec.update(H=h, K=k)
        if cfg["cap"] is not None:
            require(h & (h - 1) and k & (k - 1), f"{curve}: the capped domains {h}, {k} are not both mixed")
        require(ntt.MIXED_TRANSFORMS["cpu"] == before, f"{curve}: a mixed transform ran on the host")
        require(ok, f"{curve}: the 2^{cfg['cpu_log2']} card proof does not verify")
    require(card.hex() == ref["proof"], f"{curve}: the card's proof bytes differ from the CPU's")
    rec["bytes_equal"] = True
    if cfg["sonic_log2"]:
        n = 1 << cfg["sonic_log2"]
        rng = test_rng()
        a, b = rng.rand_fr(), rng.rand_fr()
        circ = DummyCircuit(a, b, num_variables=10, num_constraints=n)
        t = time.perf_counter()
        srs = MarlinSonic.universal_setup(n, n, 3 * n, rng, device=DEV)
        pk, vk = MarlinSonic.index(srs, circ, device=DEV)
        with counted_msm_calls() as seen, contextlib.redirect_stdout(io.StringIO()):
            proof = MarlinSonic.prove(pk, circ, rng, device=DEV)
        torch.cuda.synchronize()
        from marlin_tpu_torch.fields import active as P

        ok = MarlinSonic.verify(vk, [a * b % P.R_MODULUS], proof, rng, device=DEV)
        rec["sonic"] = {"num_constraints": n, "seconds": time.perf_counter() - t, "verifies": bool(ok),
                        "proof_bytes": proof.serialized_size(), "host_msm_calls": seen["host_calls"]}
        require(ok, f"{curve}: the MarlinSonic proof does not verify")
        require(seen["host_calls"] == 0, f"{curve}: the MarlinSonic prove called the host MSM")
    return rec


def curve_kernel_rows(curve: str, main_rec: dict, kernels: dict) -> list:
    """The kernel line's rows of one curve: each kernel's row at the curve's
    main-path shapes with its launches on that path (the combine's on the
    classic route's prove)."""
    rows = []
    for name, r in kernels.items():
        if name == "combine_windows":
            launches = main_rec["classic_launches"]["combine_windows"]
        elif name == "mont_mul":  # an entry into kernel 1: its Fr products
            launches = main_rec["binop_launches"].get("fr.mul", 0)
        else:
            launches = main_rec["launches"].get(name)
        rows.append({
            "name": f"{curve}:{name}", "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r.get("shape"),
        })
    return rows


def curve_process_main(curve: str, cpu_proof: str, out: str) -> int:
    """`--curve NAME --cpu-proof-file PATH --out PATH`: the curve's phases
    (build check, main, kernels, cpu) in this process, each printing one
    JSON line; the kernel rows and every record to PATH."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if curve == WIDE:
        return wide_process_main(cpu_proof, out)
    from marlin_tpu_torch.fields import active as P
    from marlin_tpu_torch.ops import cuda

    phase = "build"
    try:
        require(P.CURVE_NAME == curve, f"MARLIN_TPU_CURVE gives {P.CURVE_NAME}, expected {curve}")
        global PEAK_OPS_PER_S, FQ_PRODUCT_US
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import imad_rate
        import sass_count

        secs = cuda.build()
        require(cuda.lib().marlin_curve_id().decode() == curve, "the library names another curve")
        sass = sass_count.count(cuda.lib_path())
        for field in ("fr", "fq"):
            MULS_PER_PRODUCT[field] = sass["product"][field]["multiplies"]
        PEAK_OPS_PER_S = integer_peak(torch)["ops_per_s"]
        latency = {f: imad_rate.product_latency(torch, f) for f in ("fq", "fr")}
        FQ_PRODUCT_US = latency["fq"]["us_per_product"]
        emit({"phase": "build", "curve": curve, "seconds": secs, "product_sass": sass["product"],
              "kernel_sass": sass["kernels"], "product_latency": latency})

        phase = "main"
        main_rec, state = curve_main(torch, curve)
        emit({"phase": "main", **main_rec})

        phase = "serial"
        emit({"phase": "serial", "curve": curve, **serial_roundtrip(torch, np, state, curve, tamper=False)})

        phase = "kernels"
        pp = state["pk"].committer_key.pp
        set_curve_shapes(CURVES[curve]["log2"], main_rec["K"], main_rec["prove_inversions"],
                         main_rec["prove_transforms"], main_rec["prove_msm_jobs"], pp.powers_of_g[0].shape[0])
        kernels = phase_kernels(torch, np)
        emit({"phase": "kernels", "curve": curve, "results": kernels})

        phase = "cpu"
        emit({"phase": "cpu", "curve": curve, **curve_cpu_check(torch, curve, state, cpu_proof)})
    except Exception as e:
        import traceback

        traceback.print_exc()
        print(json.dumps({"phase": phase, "curve": curve, "error": f"{type(e).__name__}: {e}"}), flush=True)
        _write(out, {"records": RECORDS, "failed_phase": phase, "error": str(e)})
        return 1
    _write(out, {"records": RECORDS, "kernels": curve_kernel_rows(curve, main_rec, kernels)})
    return 0


def run_curve(curve: str, cpu: tuple) -> list:
    """Wait for the curve's CPU reference proof, run the curve's process and
    relay its lines -> its kernel rows.  Fails the run if either fails."""
    proc, cpu_out = cpu
    log, _ = proc.communicate()
    require(proc.returncode == 0, f"{curve}: the CPU reference proof failed:\n{log[-3000:]}")
    out = os.path.join(SMOKE_DIR, f"curve_{curve}.json")
    env = dict(os.environ, MARLIN_TPU_CURVE=curve)
    env.pop("MARLIN_TPU_FR_TWO_ADICITY_CAP", None)
    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--curve", curve,
                            "--cpu-proof-file", cpu_out, "--out", out],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for line in child.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            RECORDS.append(rec)
            print(line, flush=True)
    require(child.returncode == 0, f"{curve}: the curve's phases failed:\n{child.stdout[-4000:]}")
    return json.load(open(out))["kernels"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's record to this JSON file")
    ap.add_argument("--curve", choices=sorted(CURVES), help=argparse.SUPPRESS)
    ap.add_argument("--cpu-proof", choices=sorted(CURVES), help=argparse.SUPPRESS)
    ap.add_argument("--cpu-proof-file", help=argparse.SUPPRESS)
    ap.add_argument("--dist-rank", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "marlin_tpu_torch")):
        print("chip_smoke: marlin_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.cpu_proof:
        return cpu_proof_main(args.cpu_proof, args.out)
    if args.curve:
        return curve_process_main(args.curve, args.cpu_proof_file, args.out)
    if args.dist_rank is not None:
        return dist_rank_main(args.dist_rank, args.out)
    os.environ["MARLIN_TPU_CURVE"] = "bls12_381"  # this process's phases; the others run their own
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    phase = "device"
    cpu_procs = {}
    curve_rows = []
    try:
        emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda})

        phase = "build"
        emit({"phase": "build", **phase_build(torch)})
        cpu_procs = start_cpu_proofs()

        phase = "kernels"
        kernels = phase_kernels(torch, np)
        emit({"phase": "kernels", "results": kernels})

        phase = "small"
        emit({"phase": "small", **phase_small()})

        phase = "medium"
        emit({"phase": "medium", **phase_medium(torch)})

        phase = "main"
        main_rec, state = phase_main(torch)
        emit({"phase": "main", **main_rec})

        phase = "classic"
        classic_rec = phase_classic(torch, state)
        emit({"phase": "classic", **classic_rec})

        phase = "msm"
        ck = state["pk"].committer_key
        emit({"phase": "msm", **phase_msm(torch, np, ck, main_rec["prove_msm_jobs"])})

        phase = "sonic"
        emit({"phase": "sonic", **phase_sonic(torch)})

        phase = "serial"
        emit({"phase": "serial", **phase_serial(torch, np, main_rec, state)})

        phase = "sharded"
        sharded_rec = phase_sharded(torch, np, state)
        emit({"phase": "sharded", **sharded_rec})

        phase = "distributed"
        emit({"phase": "distributed", **phase_distributed(torch, state, sharded_rec)})

        for curve in CURVES:
            phase = curve
            curve_rows += run_curve(curve, cpu_procs.pop(curve))
    except Exception as e:  # every phase failure ends the run without a result
        import traceback

        traceback.print_exc()
        print(json.dumps({"phase": phase, "error": f"{type(e).__name__}: {e}"}), flush=True)
        if args.out:
            _write(args.out, {"records": RECORDS, "failed_phase": phase, "error": str(e)})
        return 1
    finally:
        for proc, _ in cpu_procs.values():  # reference proofs a failure left running
            proc.kill()
            proc.communicate()

    fr_mul_launches = main_rec["binop_launches"].get("fr.mul", 0)
    table = []
    for name, r in kernels.items():
        # kernel 6 runs on the classic path only: its count is the classic prove's
        launches = {"mont_mul": fr_mul_launches,
                    "combine_windows": classic_rec["launches"]["combine_windows"]}.get(
                        name, main_rec["launches"].get(name))
        table.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    table += [{k: v for k, v in row.items() if k != "shape"} for row in curve_rows]
    if args.out:
        _write(args.out, {"records": RECORDS, "kernels": table, "curve_kernels": curve_rows, "nvidia_smi": smi})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


def _write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
