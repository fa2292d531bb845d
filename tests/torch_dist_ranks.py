"""The rank processes of tests/test_torch_distributed.py.

    python tests/torch_dist_ranks.py ranks|reference RANK STORE OUT TIMEOUT_S

CASE "ranks": each of the WORLD ranks starts the port's process group
(`multihost.init_distributed`, gloo over the file store STORE, TIMEOUT_S
on every collective), builds the (dcn, ici) = (WORLD, SHARDS) mesh of CPU
shards with `make_mesh()`, and runs (`run_all`) the four-step NTTs at N_NTT
(both variants, forward and inverse, and over the "ici" axis alone, which
lies whole on each rank), the three MSM bodies of
`msm_sharded_core` under `small_thresholds`, the spill case (one repeated
scalar, whose exact rerun must run on every rank) and
`Marlin.prove(mesh=...)` of the NC-constraint `DummyCircuit` with
NTT_MIN_SHARDED = NC.  Then rank 1 raises and leaves, and rank 0 runs an
NTT, whose first collective must raise instead of waiting on the dead
rank (`fail_one_rank`).  The limbs go to OUT/rank<r>.npz, the rest to
OUT/rank<r>.json.

CASE "reference" (one process, no group): the MSM bodies on the
one-process mesh of the same shape, to OUT/reference.npz and .json.

The inputs come from numpy seeds through the functions below, which the
test imports to build the same inputs in its own process.  Nothing here
imports JAX.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from marlin_tpu_torch.fields import active as P  # noqa: E402
from marlin_tpu_torch.fields import host_curve as hc  # noqa: E402
from marlin_tpu_torch.ops import curve_device as cd  # noqa: E402
from marlin_tpu_torch.ops import fr, msm  # noqa: E402
from marlin_tpu_torch.parallel import collectives, msm_sharded, multihost, ntt_sharded  # noqa: E402
from marlin_tpu_torch.parallel import context as pctx  # noqa: E402
from marlin_tpu_torch.snark.r1cs import lc  # noqa: E402

R = P.R_MODULUS
WORLD = 2
SHARDS = 4  # CPU shards a rank
N_NTT = 1 << 8
# (body, data axis, points): 8, 16 and 64 points a position
MSM_CASES = (("ladder", None, 64), ("window_block", None, 128), ("point", "dcn", 128))
SPILL_N = 32
NC = 64  # constraints of the prove; |H| = 64 and NTT_MIN_SHARDED = 64


def scalars(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]


def even_scalars(rng, n, c=6):
    """Scalars whose radix-2^c digits fill the buckets evenly (as in
    tests/test_torch_sharded.py), so the capped bodies do not spill."""
    W = -(-P.FR_BITS // c)
    a = [int(v) | 1 for v in rng.integers(0, 1 << c, W)]
    b = [int(v) for v in rng.integers(0, 1 << c, W)]
    return [sum(((a[w] * i + b[w]) % (1 << c)) << (c * w) for w in range(W - 1)) + ((i % 7) << (c * (W - 1)))
            for i in range(n)]


def ntt_input() -> list:
    return scalars(np.random.default_rng(23), N_NTT)


def msm_case(n: int):
    """-> (affine points as ints, scalars) of the n-point case."""
    rng = np.random.default_rng(n)
    affs = hc.g1_fixed_base_powers(hc.G1_GEN, [s or 1 for s in scalars(rng, n)])
    return affs, even_scalars(rng, n)


def spill_case():
    """-> (affine points, one scalar repeated SPILL_N times): every window's
    entries share one bucket, beyond its capacity."""
    affs, _ = msm_case(SPILL_N)
    k = scalars(np.random.default_rng(8), 1)[0]
    return affs, [k] * SPILL_N


def small_thresholds() -> dict:
    """Ladder below 16 points a position, window blocks below 64, point
    shards from 64; sharded MSMs from 16 points (tests/test_torch_sharded.py)
    -> the values they replace."""
    old = {"pip": msm._PIPPENGER_MIN, "wb": msm_sharded.WINDOW_BLOCK_MAX, "min": pctx.MSM_MIN_SHARDED}
    msm._PIPPENGER_MIN, msm_sharded.WINDOW_BLOCK_MAX, pctx.MSM_MIN_SHARDED = 16, 64, 16
    return old


def restore_thresholds(old: dict) -> None:
    msm._PIPPENGER_MIN, msm_sharded.WINDOW_BLOCK_MAX, pctx.MSM_MIN_SHARDED = old["pip"], old["wb"], old["min"]


class DummyCircuit:
    """The bench circuit (reference benches/bench.rs:25-67) over the port's
    constraint system."""

    def __init__(self, a, b, num_variables, num_constraints):
        self.a, self.b, self.nv, self.nc = a, b, num_variables, num_constraints

    def generate_constraints(self, cs):
        a = cs.new_witness_variable(lambda: self.a)
        b = cs.new_witness_variable(lambda: self.b)
        c = cs.new_input_variable(lambda: self.a * self.b % R)
        for _ in range(self.nv - 3):
            cs.new_witness_variable(lambda: self.a)
        for _ in range(self.nc - 1):
            cs.enforce_constraint(lc(a), lc(b), lc(c))
        cs.enforce_constraint(lc(), lc(), lc())


def prove_circuit():
    """-> (circuit, public input) of the prove."""
    return DummyCircuit(11, 13, num_variables=10, num_constraints=NC), [11 * 13 % R]


def msm_bodies(mesh, arrays: dict, rec: dict) -> None:
    """The three bodies of `msm_sharded_core` over `mesh` under
    `small_thresholds`: their Jacobian limbs into `arrays`, their spill
    counts into `rec`."""
    old = small_thresholds()
    try:
        for body, axis, n in MSM_CASES:
            affs, scal = msm_case(n)
            pt, spill = msm_sharded.msm_sharded_core(cd.from_affine_ints(affs, "cpu"), fr.from_ints(scal, "cpu"),
                                                     mesh, axis)
            arrays[f"msm_{body}"] = torch.stack(pt).numpy()
            rec[f"spill_{body}"] = int(spill)
    finally:
        restore_thresholds(old)


def run_all(mesh) -> tuple:
    """-> (arrays, record) of the cases on this rank."""
    from marlin_tpu_torch.snark.marlin import Marlin
    from marlin_tpu_torch.utils.rand import test_rng

    arrays, rec = {}, {"mesh_ranks": mesh.ranks.tolist(), "mesh_shape": mesh.shape}
    x = fr.from_ints(ntt_input(), "cpu")
    for name, fn in (("4step", ntt_sharded.ntt_4step), ("resident", ntt_sharded.ntt_4step_resident)):
        for inverse in (False, True):
            arrays[f"ntt_{name}_{int(inverse)}"] = fn(x, mesh, inverse=inverse).numpy()
    before = sum(v for k, v in collectives.EXCHANGES.items() if k != "bytes")
    arrays["ntt_ici"] = ntt_sharded.ntt_4step(x, mesh, axis=multihost.ICI_AXIS).numpy()
    rec["ici_exchanges"] = sum(v for k, v in collectives.EXCHANGES.items() if k != "bytes") - before
    msm_bodies(mesh, arrays, rec)

    affs, scal = spill_case()
    reruns = []
    exact = msm.msm_pippenger

    def counting(*args, **kwargs):
        reruns.append(kwargs)
        return exact(*args, **kwargs)

    old = small_thresholds()
    msm.msm_pippenger = counting
    try:
        got = msm_sharded.msm_sharded(cd.from_affine_ints(affs, "cpu"), fr.from_ints(scal, "cpu"), mesh, "dcn")
    finally:
        msm.msm_pippenger = exact
        restore_thresholds(old)
    rec["spill_reruns"] = reruns
    rec["spill_case_point"] = [str(v) for v in cd.to_affine_ints(got)[0]]

    calls = []
    four_step = ntt_sharded.ntt_4step_resident
    ntt_sharded.ntt_4step_resident = lambda *a, **k: calls.append(1) or four_step(*a, **k)
    old_min = pctx.NTT_MIN_SHARDED
    pctx.NTT_MIN_SHARDED = NC
    try:
        circ, public = prove_circuit()
        srs = Marlin.universal_setup(NC, NC, 3 * NC, test_rng(), device="cpu")
        pk, vk = Marlin.index(srs, circ, device="cpu")
        proof = Marlin.prove(pk, circ, test_rng(), device="cpu", mesh=mesh)
    finally:
        pctx.NTT_MIN_SHARDED = old_min
        ntt_sharded.ntt_4step_resident = four_step
    rec.update(proof=proof.to_bytes().hex(), sharded_ntts=len(calls),
               verifies=bool(Marlin.verify(vk, public, proof, test_rng(), device="cpu")),
               exchanges=dict(collectives.EXCHANGES), route=collectives.route(x), backend=multihost.backend())
    return arrays, rec


def fail_one_rank(rank: int, mesh) -> dict:
    """Rank 1 raises and leaves; rank 0's next collective (an NTT's
    all-to-all) must raise instead of waiting on it -> what each raised,
    and after how long."""
    t = time.perf_counter()
    try:
        if rank == 1:
            raise RuntimeError("rank 1 fails on purpose")
        ntt_sharded.ntt_4step(fr.from_ints(ntt_input(), "cpu"), mesh)
        raised = None
    except RuntimeError as e:
        raised = f"{type(e).__name__}: {e}"
    return {"raised": raised, "seconds": time.perf_counter() - t}


def main(argv) -> int:
    """CASE RANK STORE OUT TIMEOUT_S: rank RANK of case "ranks", or case
    "reference"."""
    case, rank, store, out, timeout_s = argv[0], int(argv[1]), argv[2], argv[3], float(argv[4])
    torch.set_num_threads(1)
    name = "reference" if case == "reference" else f"rank{rank}"
    rec = {"rank": rank}
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():  # no autograd bookkeeping: the plain versions' small ops run faster
            if case == "reference":
                arrays = {}
                msm_bodies(multihost.make_mesh(num_hosts=WORLD, devices=[torch.device("cpu")] * (WORLD * SHARDS)),
                           arrays, rec)
            else:
                multihost.init_distributed(devices=["cpu"] * SHARDS, init_method=f"file://{store}", rank=rank,
                                           world_size=WORLD, timeout=datetime.timedelta(seconds=timeout_s))
                mesh = multihost.make_mesh()
                arrays, more = run_all(mesh)
                rec.update(more)
                rec["failing_rank"] = fail_one_rank(rank, mesh)  # the group is broken from here on
            np.savez(os.path.join(out, f"{name}.npz"), **arrays)
    except Exception as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    finally:
        rec["seconds"] = time.perf_counter() - t0
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump(rec, f)
    return 1 if "error" in rec else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
