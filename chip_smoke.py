#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (marlin_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out PATH]

Phases, each printing one line of JSON:

1. device  — the card's name, count and `nvidia-smi` name/power limit;
2. build   — compile the CUDA kernels (marlin_tpu_torch/csrc) from source;
3. kernels — every kernel against its plain PyTorch version on the card,
   bit for bit, at the main path's shapes, with edge inputs 0, 1, N-1; each
   timed with CUDA events beside its plain version;
4. small   — a one-constraint circuit (SRS 32/32/96) proved under
   `test_rng()` on the CPU (plain versions) and on the card: equal proof
   bytes, the card's proof verifies, a wrong input and a flipped byte are
   rejected;
5. main    — the 2^14-constraint MarlinKZG10 prove over BLS12-381
   (`DummyCircuit`, SRS sized by `ahp.max_degree(n, n, 3n)`): setup, index,
   prove, verify, with phase and round seconds and each kernel's launch
   count, all of which must be above 0; the proof must verify and be 855 B.

Then the kernel table, the card's name and power limit, and, as the last
line, `{"ok": true, "device": {...}}`.  Any failure exits nonzero before
that line.  Needs one CUDA device and the repository beside this script;
imports nothing of JAX.  `--out` also writes every phase's record to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks used for bounds (NVIDIA data sheet): HBM bandwidth, and the 67 T/s float32 rate outside the tensor
# cores, taken as the ceiling for 32-bit integer multiplies (a lower bound on
# the time; the card's integer multiply rate is below it).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# the main path's shapes: |H| = 2^14 constraints, |K| = the mul domain = 2^16
MAIN_LOG2 = 14
FR_N = 1 << 16
FQ_N = 1 << 14
MONT_N = 4096
NTT_SHAPES = ((1 << 14,), (1 << 16,), (4, 1 << 16))
NTT_CROSS_STAGE = 15
DEV = "cuda"

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


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mont_mul_ops(nl: int) -> int:
    """32-bit multiplies in one CIOS product over nl limbs."""
    return 2 * nl * nl + nl


# --------------------------------------------------------------------------


def random_elements(np, rng, ctx, n: int):
    """[n, L] canonical limbs (< N) with the edge values 0, 1, N-1, N-2 first."""
    from marlin_tpu_torch.ops.limbs import int_to_limbs

    L = ctx.L
    x = rng.integers(0, 1 << 16, size=(n, L), dtype=np.int64)
    x[:, -1] = rng.integers(0, int(ctx.n_limbs[-1]), size=n)  # top limb below N's
    for i, v in enumerate((0, 1, ctx.modulus - 1, ctx.modulus - 2)):
        x[i] = int_to_limbs(v, L)
    return x.astype(np.int32)


def phase_kernels(torch, np) -> dict:
    from marlin_tpu_torch.ops import bigint as bi
    from marlin_tpu_torch.ops import cuda, fq, fr, mont, ntt

    rng = np.random.default_rng(1)
    dev = torch.device(DEV)
    results = {}

    def err(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())

    # kernel 1: Fr at 2^16 and Fq at 2^14, mul / add / sub
    binop_err = 0
    checks = []
    for ctx, n in ((fr.CTX, FR_N), (fq.CTX, FQ_N)):
        a = torch.as_tensor(random_elements(np, rng, ctx, n), device=dev)
        b = torch.as_tensor(random_elements(np, rng, ctx, n), device=dev).flip(0).contiguous()
        for kind, plain in (("mul", bi.mont_mul), ("add", bi.add_mod), ("sub", bi.sub_mod)):
            e = err(bi.binop_kernel(kind, ctx, a, b), plain(ctx, a, b))
            torch.cuda.synchronize()
            checks.append({"field": ctx.name, "op": kind, "n": n, "max_abs_err": e})
            binop_err = max(binop_err, e)
    n16 = FR_N
    a16 = torch.as_tensor(random_elements(np, rng, fr.CTX, n16), device=dev)
    b16 = torch.as_tensor(random_elements(np, rng, fr.CTX, n16), device=dev)
    b_bytes, b_by = bound(3 * n16 * 64, n16 * mont_mul_ops(8))
    results["field_binop"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/field.cu",
        "replaces": "marlin_tpu/ops/pallas/field.py:101",
        "max_abs_err": binop_err, "checks": checks, "shape": f"fr mul [{n16}, 16]",
        "ms": time_ms(torch, lambda: bi.binop_kernel("mul", fr.CTX, a16, b16)),
        "plain_ms": time_ms(torch, lambda: bi.mont_mul(fr.CTX, a16, b16), reps=5),
        "bound_ms": b_bytes, "bound_by": b_by, "library_ms": None,
    }

    # kernel 2: inversion at 2^16 with zeros mixed in
    x = torch.as_tensor(random_elements(np, rng, fr.CTX, n16), device=dev)
    x[torch.as_tensor(rng.choice(n16, 64, replace=False), device=dev)] = 0
    inv_k = bi.inv_kernel(fr.CTX, x)
    inv_p = bi.inv_mod(fr.CTX, x)
    e_inv = err(inv_k, inv_p)
    require(bool((inv_k[(x == 0).all(-1)] == 0).all()), "inv(0) != 0")
    # the products of the nonzero inputs with their inverses must be one
    prod = bi.binop_kernel("mul", fr.CTX, x, inv_k)
    nz = ~(x == 0).all(-1)
    one = torch.as_tensor(fr.CTX.one_limbs.astype(np.int32), device=dev)
    require(bool((prod[nz] == one).all()), "x * inv(x) != 1")
    e_bits = fr.CTX.inv_exp_bits
    inv_muls = len(e_bits) + int(e_bits.sum())
    b_ms, b_by = bound(2 * n16 * 64, n16 * inv_muls * mont_mul_ops(8))
    results["field_inv"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/field.cu",
        "replaces": "marlin_tpu/ops/pallas/field.py:126",
        "max_abs_err": e_inv, "shape": f"fr [{n16}, 16]",
        "ms": time_ms(torch, lambda: bi.inv_kernel(fr.CTX, x), reps=10),
        "plain_ms": time_ms(torch, lambda: bi.inv_mod(fr.CTX, x), reps=1, warmup=0),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }

    # kernel 3: whole transforms against the plain twins, then each stage kernel
    ntt_checks = []
    ntt_err = 0
    for shape in NTT_SHAPES:
        flat = int(np.prod(shape))
        v = torch.as_tensor(random_elements(np, rng, fr.CTX, flat), device=dev).reshape(*shape, fr.L)
        for inverse in (False, True):
            k_out = ntt.transform(v, inverse)
            p_out = ntt.transform(v, inverse, plain=True)
            e = err(k_out, p_out)
            ntt_checks.append({"shape": list(shape), "inverse": inverse, "max_abs_err": e})
            ntt_err = max(ntt_err, e)
    # ntt_many == per-poly ntt, and intt(ntt(p)) == p
    polys = [torch.as_tensor(random_elements(np, rng, fr.CTX, n16 // 2 - 3 * i), device=dev) for i in range(4)]
    many = ntt.ntt_many(polys, n16)
    for p, m in zip(polys, many):
        require(torch.equal(m, ntt.ntt(p, n16)), "ntt_many != ntt")
        require(torch.equal(ntt.intt(m)[: p.shape[0]], p), "intt(ntt(p)) != p")

    rev, tw = ntt._plan_tensors(n16, False, dev)
    base = torch.as_tensor(random_elements(np, rng, fr.CTX, n16), device=dev)
    log_b = ntt.BLOCK_LOG2
    e_blk = err(ntt.block_stages_kernel(base.clone(), tw, log_b), ntt.block_stages_plain(base, tw, log_b))
    s_top = NTT_CROSS_STAGE
    e_cross = err(ntt.cross_stage_kernel(base.clone(), tw, s_top), ntt.cross_stage_plain(base, tw, s_top))
    scratch = base.clone()
    blk_bytes = 2 * n16 * 64 + ((1 << log_b) - 1) * 64
    b_ms, b_by = bound(blk_bytes, (n16 // 2) * log_b * mont_mul_ops(8))
    results["ntt_block_stages"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/ntt.cu",
        "replaces": "marlin_tpu/ops/pallas/ntt.py:91",
        "max_abs_err": max(ntt_err, e_blk), "checks": ntt_checks,
        "shape": f"[{n16}, 16], {log_b} stages",
        "ms": time_ms(torch, lambda: ntt.block_stages_kernel(scratch, tw, log_b)),
        "plain_ms": time_ms(torch, lambda: ntt.block_stages_plain(base, tw, log_b), reps=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    b_ms, b_by = bound(2 * n16 * 64 + (1 << s_top) * 64, (n16 // 2) * mont_mul_ops(8))
    results["ntt_cross_stage"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/ntt.cu",
        "replaces": "marlin_tpu/ops/pallas/ntt.py:91",
        "max_abs_err": max(ntt_err, e_cross), "shape": f"[{n16}, 16], stage {s_top}",
        "ms": time_ms(torch, lambda: ntt.cross_stage_kernel(scratch, tw, s_top)),
        "plain_ms": time_ms(torch, lambda: ntt.cross_stage_plain(base, tw, s_top), reps=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }

    # kernel 7 of the TPU package: mont_mul on [4096, 16] (an entry into kernel 1)
    ma = torch.as_tensor(random_elements(np, rng, fr.CTX, MONT_N), device=dev)
    mb = torch.as_tensor(random_elements(np, rng, fr.CTX, MONT_N), device=dev)
    b_ms, b_by = bound(3 * MONT_N * 64, MONT_N * mont_mul_ops(8))
    results["mont_mul"] = {
        "route": "cuda", "source": "marlin_tpu_torch/csrc/field.cu",
        "replaces": "marlin_tpu/ops/pallas/mont.py:83",
        "max_abs_err": err(mont.mont_mul(ma, mb), bi.mont_mul(fr.CTX, ma, mb)),
        "shape": f"[{MONT_N}, 16]",
        "ms": time_ms(torch, lambda: mont.mont_mul(ma, mb)),
        "plain_ms": time_ms(torch, lambda: bi.mont_mul(fr.CTX, ma, mb), reps=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }
    torch.cuda.synchronize()
    for name, r in results.items():
        require(r["max_abs_err"] == 0, f"{name} disagrees with its plain version: {r}")
    cuda.reset_launches()
    return results


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
        from marlin_tpu_torch.fields import bls12_381 as P
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


def phase_main(torch) -> dict:
    import contextlib
    import io

    from marlin_tpu_torch.fields import bls12_381 as P
    from marlin_tpu_torch.ops import cuda
    from marlin_tpu_torch.snark import ahp
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
    profiling.enable(True)
    profiling.collect()
    with contextlib.redirect_stdout(io.StringIO()):
        proof = timed("prove", lambda: Marlin.prove(pk, circ, rng, device=DEV))
    spans = profiling.collect()
    profiling.enable(False)
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
        binop_launches=binop_by_op,
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
        require(v > 0, f"kernel {k} was not launched on the main path")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every phase's record to this JSON file")
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(ROOT, "marlin_tpu_torch")):
        print("chip_smoke: marlin_tpu_torch/ is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    phase = "device"
    try:
        emit({"phase": "device", "kind": kind, "count": count, "nvidia_smi": smi,
              "torch": torch.__version__, "cuda": torch.version.cuda})

        phase = "build"
        from marlin_tpu_torch.ops import cuda

        secs = cuda.build()
        cuda.lib()
        emit({"phase": "build", "seconds": secs})

        phase = "kernels"
        kernels = phase_kernels(torch, np)
        emit({"phase": "kernels", "results": kernels})

        phase = "small"
        emit({"phase": "small", **phase_small()})

        phase = "main"
        main_rec = phase_main(torch)
        emit({"phase": "main", **main_rec})
    except Exception as e:  # every phase failure ends the run without a result
        import traceback

        traceback.print_exc()
        print(json.dumps({"phase": phase, "error": f"{type(e).__name__}: {e}"}), flush=True)
        if args.out:
            _write(args.out, {"records": RECORDS, "failed_phase": phase, "error": str(e)})
        return 1

    fr_mul_launches = main_rec["binop_launches"].get("fr.mul", 0)
    table = []
    for name, r in kernels.items():
        launches = fr_mul_launches if name == "mont_mul" else main_rec["launches"][name]
        table.append({
            "name": name, "route": r["route"], "source": r["source"], "replaces": r["replaces"],
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    if args.out:
        _write(args.out, {"records": RECORDS, "kernels": table, "nvidia_smi": smi})
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
