"""The port's mesh across processes (`multihost.init_distributed`), on CPU
ranks.

Two gloo ranks (tests/torch_dist_ranks.py) on a file store under the
test's temporary directory, each with four CPU shards: the mesh is
(dcn, ici) = 2 x 4, and every exchange between the ranks is a
`torch.distributed` collective (parallel/collectives.py).  Held against
what this process computes on the same seeded inputs:

* the four-step NTT and its resident variant at 2^8, forward and inverse,
  limb for limb against the JAX package's `ntt_4step` on an 8-device JAX
  CPU mesh and the single-device port;
* the three bodies of `msm_sharded_core` (ladder, window blocks, point
  shards) under tests/test_torch_sharded.py's small thresholds: the
  affine point against the JAX package's host MSM, and the Jacobian limbs
  against the one-process 2 x 4 mesh's (computed in a third process beside
  the ranks, case "reference");
* the spill case: one repeated scalar overflows the capped buckets, and
  both ranks rerun the exact single-device MSM;
* `Marlin.prove(mesh=...)` at 64 constraints (NTT_MIN_SHARDED = 64): both
  ranks return the single-device bytes, and the proof verifies;
* then a rank that raises makes the other raise within the group's
  timeout;
  `init_distributed()` returns False without the variables (as the JAX
  package's does), reads torchrun's variables when they are set, and a
  mesh spanning processes is refused without the group;
* the backend rule on device layouts.
"""

import datetime
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import torch_dist_ranks as W
from marlin_tpu.fields import host_curve as jhc
from marlin_tpu.ops import fr as jfr
from marlin_tpu.parallel import multihost as jmultihost
from marlin_tpu.parallel.ntt_sharded import ntt_4step as jax_ntt_4step
from marlin_tpu_torch.ops import curve_device as cd
from marlin_tpu_torch.ops import fr, ntt
from marlin_tpu_torch.parallel import context as pctx
from marlin_tpu_torch.parallel import multihost, ntt_sharded
from marlin_tpu_torch.snark.marlin import Marlin
from marlin_tpu_torch.utils.rand import test_rng as seeded_rng

CPU = torch.device("cpu")
GROUP_TIMEOUT_S = 60  # the ranks' process-group timeout
SPAWN_LIMIT_S = 300  # each rank process's time limit


def _spawn(case: str, out, group_timeout_s: float, ranks=range(W.WORLD)) -> list:
    store = os.path.join(out, "store")
    return [subprocess.Popen([sys.executable, W.__file__, case, str(r), store, str(out), str(group_timeout_s)],
                             cwd=W.ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in ranks]


def _wait(procs: list, out, names) -> list:
    """Each process's record (and limbs), after its exit."""
    results = []
    for name, proc in zip(names, procs):
        try:
            log, _ = proc.communicate(timeout=SPAWN_LIMIT_S)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        with open(os.path.join(out, f"{name}.json")) as f:
            rec = json.load(f)
        npz = os.path.join(out, f"{name}.npz")
        if os.path.exists(npz):
            with np.load(npz) as z:
                rec["arrays"] = {k: z[k] for k in z.files}
        rec["rc"], rec["log"] = proc.returncode, log
        results.append(rec)
    return results


def _references() -> dict:
    """What the ranks must give, computed here while they run (the
    one-process mesh's MSM limbs in a process of their own, case
    "reference")."""
    refs = {}
    vals = W.ntt_input()
    x = fr.from_ints(vals, "cpu")
    jmesh = JaxMesh(np.array(jax.devices()[:8]), ("x",))
    for inverse in (False, True):
        refs[("ntt", inverse)] = ntt.transform(x, inverse).numpy()
        refs[("jax_ntt", inverse)] = np.asarray(jax_ntt_4step(jfr.from_ints(vals), jmesh, inverse=inverse))
    for body, _, n in W.MSM_CASES:
        refs[("host", body)] = jhc.g1_msm(*W.msm_case(n))
    refs["spill_host"] = jhc.g1_msm(*W.spill_case())
    circ, _ = W.prove_circuit()
    srs = Marlin.universal_setup(W.NC, W.NC, 3 * W.NC, seeded_rng(), device="cpu")
    pk, _ = Marlin.index(srs, circ, device="cpu")
    refs["proof"] = Marlin.prove(pk, circ, seeded_rng(), device="cpu").to_bytes().hex()
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Case "ranks" on two ranks, and the references beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("ranks")
    procs = _spawn("ranks", out, GROUP_TIMEOUT_S) + _spawn("reference", out, GROUP_TIMEOUT_S, ranks=[0])
    try:
        refs = _references()
    finally:
        results = _wait(procs, out, [f"rank{r}" for r in range(W.WORLD)] + ["reference"])
        torch.set_num_threads(threads)
    for rec in results:
        assert rec["rc"] == 0 and "error" not in rec, rec.get("traceback") or rec["log"][-3000:]
    for body, _, _ in W.MSM_CASES:
        refs[("msm", body)] = results[-1]["arrays"][f"msm_{body}"]
    return results[:-1], refs


def test_two_ranks_build_one_mesh_and_exchange_by_gloo(ranks):
    results, _ = ranks
    for rec in results:
        assert rec["mesh_shape"] == {"dcn": 2, "ici": 4}
        assert rec["mesh_ranks"] == [[0] * 4, [1] * 4]
        assert rec["backend"] == "gloo" and rec["route"] == "gloo"
        ex = rec["exchanges"]
        assert ex["all_to_all"] > 0 and ex["all_gather"] > 0 and ex["all_reduce"] > 0 and ex["bytes"] > 0
    assert results[0]["exchanges"] == results[1]["exchanges"]


def test_an_axis_whole_on_each_rank_runs_there_without_exchanges(ranks):
    """Over the "ici" axis each rank holds every position of its own
    replica, so each computes the whole transform with no collective."""
    results, refs = ranks
    for rec in results:
        assert np.array_equal(rec["arrays"]["ntt_ici"], refs[("ntt", False)])
        assert rec["ici_exchanges"] == 0


@pytest.mark.parametrize("variant", ["4step", "resident"])
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_ntts_across_ranks_equal_the_jax_package_and_one_device(ranks, variant, inverse):
    results, refs = ranks
    assert np.array_equal(refs[("ntt", inverse)], refs[("jax_ntt", inverse)].astype(np.int32))
    for rec in results:
        assert np.array_equal(rec["arrays"][f"ntt_{variant}_{int(inverse)}"], refs[("ntt", inverse)])


@pytest.mark.parametrize("body", [b for b, _, _ in W.MSM_CASES])
def test_msm_bodies_across_ranks_equal_the_host_msm_and_the_one_process_mesh(ranks, body):
    results, refs = ranks
    for rec in results:
        limbs = rec["arrays"][f"msm_{body}"]
        assert rec[f"spill_{body}"] == 0
        assert np.array_equal(limbs, refs[("msm", body)])  # Jacobian limbs, not only the point
        assert cd.to_affine_ints(tuple(torch.as_tensor(c) for c in limbs)) == [refs[("host", body)]]


def test_a_spill_reruns_exactly_on_both_ranks(ranks):
    results, refs = ranks
    for rec in results:
        assert rec["spill_reruns"] == [{"exact": True}]
        assert [int(v) for v in rec["spill_case_point"]] == list(refs["spill_host"])


def test_two_ranks_prove_the_single_device_bytes(ranks):
    results, refs = ranks
    for rec in results:
        assert rec["proof"] == refs["proof"]
        assert rec["verifies"] and rec["sharded_ntts"] > 0


def test_a_failing_rank_makes_the_other_raise(ranks):
    """After the cases above, rank 1 raises and leaves; rank 0's next
    collective raises (the peer's connection closes, or the group's
    timeout passes) instead of waiting."""
    results, _ = ranks
    assert "on purpose" in results[1]["failing_rank"]["raised"]
    assert results[0]["failing_rank"]["raised"], results[0]["failing_rank"]
    assert results[0]["failing_rank"]["seconds"] < GROUP_TIMEOUT_S + 10


def test_init_distributed_without_the_variables_returns_false(monkeypatch):
    for var in ("MASTER_ADDR", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.init_distributed() is False
    assert jmultihost.init_distributed() is False
    assert multihost.backend() is None and multihost.world_size() == 1 and multihost.rank() == 0


def test_init_distributed_reads_torchruns_variables(monkeypatch):
    """One rank from MASTER_ADDR, MASTER_PORT (a port the system gave out),
    WORLD_SIZE, RANK and LOCAL_RANK: the group starts on gloo (no card),
    make_mesh() is its one-position mesh, and shutdown() ends it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        assert multihost.init_distributed(timeout=datetime.timedelta(seconds=30)) is True
        assert (multihost.rank(), multihost.world_size(), multihost.backend()) == (0, 1, "gloo")
        mesh = multihost.make_mesh()
        assert mesh.shape == {"dcn": 1, "ici": 1} and mesh.ranks.tolist() == [[0]]
        with pytest.raises(RuntimeError, match="already"):
            multihost.init_distributed()
    finally:
        multihost.shutdown()
    assert multihost.backend() is None and not torch.distributed.is_initialized()


def test_a_mesh_spanning_processes_is_refused_without_the_group():
    devs = np.array([[CPU] * 4] * 2, dtype=object)
    mesh = multihost.Mesh(devs, multihost.DATA_AXES, np.array([[0] * 4, [1] * 4]))
    assert mesh.spans_processes
    x = fr.from_ints(W.ntt_input(), "cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        ntt_sharded.ntt_4step(x, mesh)
    with pytest.raises(RuntimeError, match="init_distributed"):
        with pctx.use_mesh(mesh):
            pass
    srs = Marlin.universal_setup(16, 16, 48, seeded_rng(), device="cpu")
    small = W.DummyCircuit(11, 13, num_variables=10, num_constraints=16)
    pk, _ = Marlin.index(srs, small, device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        Marlin.prove(pk, small, seeded_rng(), device="cpu", mesh=mesh)
    assert pctx.current() is None


@pytest.mark.parametrize("layout, want", [
    ([("h", ["cpu"] * 4), ("h", ["cpu"] * 4)], "gloo"),  # ranks on the CPU
    ([("h", ["cuda:0", "cuda:1"]), ("h", ["cuda:2", "cuda:3"])], "nccl"),  # each rank its own cards
    ([("h", ["cuda:0", "cuda:0"]), ("h", ["cuda:1", "cuda:1"])], "nccl"),  # a card twice within a rank
    ([("h", ["cuda:0", "cuda:0"]), ("h", ["cuda:0", "cuda:0"])], "gloo"),  # one card for both ranks
    ([("a", ["cuda:0"]), ("b", ["cuda:0"])], "nccl"),  # the same index on two hosts
    ([("h", ["cuda:0"]), ("h", ["cpu"])], "gloo"),
])
def test_the_backend_follows_the_device_layout(layout, want):
    assert multihost.backend_for(layout) == want
