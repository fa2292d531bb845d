"""The port's mesh layer (marlin_tpu_torch.parallel) on CPU meshes.

Mirrors tests/test_sharded.py, tests/test_multihost.py and
tests/test_marlin_sharded.py on meshes of `torch.device("cpu")` repeated:
four and eight devices on one axis, and a (dcn, ici) = 2 x 4 mesh.

* the four-step NTT and its resident variant, forward and inverse, limb
  for limb against the single-device port and the JAX package's
  `ntt_4step` on the same seeded input;
* the three bodies of `msm_sharded_core` (ladder, window blocks, point
  shards) as affine points against the single-device port and the JAX
  package's host MSM; the routing thresholds of the Pippenger bodies
  (`ops.msm._PIPPENGER_MIN`, `msm_sharded.WINDOW_BLOCK_MAX`) are lowered
  so that each body runs at a size the plain versions take in seconds;
* the spill fallback: one scalar for every point overflows the capped
  buckets, and the exact single-device rerun gives the right point;
* a size that does not divide the mesh takes the single-device path (an
  NTT) or is padded (an MSM);
* a mesh of another device type than the operands' is refused, and each
  shard's work runs under `on_device` of its own device (what a mesh of
  distinct cards needs: tests/test_torch_cuda.py runs one where there
  are two cards);
* `Marlin.prove(mesh=...)` gives the single-device proof bytes
  (tests/test_torch_serial.py holds a mesh prove against the JAX
  package's bytes).

The capped bodies are compared on scalars whose digits fill every bucket
evenly, so the fast path itself (no spill) is what is compared: at these
toy sizes a bucket's mean load is 1-2, and random scalars overflow one of
the 8-slot buckets often, which the spill test covers.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from marlin_tpu.fields import host_curve as jhc
from marlin_tpu.ops import fr as jfr
from marlin_tpu.parallel.ntt_sharded import ntt_4step as jax_ntt_4step
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.fields import host_curve as hc
from marlin_tpu_torch.ops import curve_device as cd
from marlin_tpu_torch.ops import fq, fr, msm, ntt
from marlin_tpu_torch.parallel import context as pctx
from marlin_tpu_torch.parallel import msm_sharded, ntt_sharded
from marlin_tpu_torch.parallel.multihost import (
    DATA_AXES,
    Mesh,
    axis_devices,
    axis_flat_index,
    axis_size,
    make_mesh,
)
from marlin_tpu_torch.snark.marlin import Marlin
from marlin_tpu_torch.snark.r1cs import lc
from marlin_tpu_torch.utils.rand import test_rng as seeded_rng

R = P.R_MODULUS
CPU = torch.device("cpu")
N_NTT = 1 << 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the plain versions' tensors are
    small, so one thread runs them as fast alone and far faster beside the
    other test workers than a pool that spins on every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _line(k):
    return Mesh(np.array([CPU] * k, dtype=object), ("x",))


MESHES = {"cpu4": lambda: _line(4), "cpu8": lambda: _line(8),
          "2x4": lambda: make_mesh(num_hosts=2, devices=[CPU] * 8)}


def _scalars(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]


def _even_scalars(rng, n, c=6):
    """Scalars whose radix-2^c digits fill the buckets evenly: window w's
    digit of scalar i is (a_w·i + b_w) mod 2^c (a_w odd, so any 2^c
    consecutive scalars take every digit once), the top window's i mod 7
    (7·2^252 < r)."""
    W = -(-P.FR_BITS // c)
    a = [int(v) | 1 for v in rng.integers(0, 1 << c, W)]
    b = [int(v) for v in rng.integers(0, 1 << c, W)]
    out = [sum(((a[w] * i + b[w]) % (1 << c)) << (c * w) for w in range(W - 1)) + ((i % 7) << (c * (W - 1)))
           for i in range(n)]
    assert max(out) < R
    return out


def _points(rng, n):
    return hc.g1_fixed_base_powers(hc.G1_GEN, [s or 1 for s in _scalars(rng, n)])


@pytest.fixture(scope="module")
def ntt_case():
    """A seeded vector and the JAX package's four-step transforms of it on
    an 8-device mesh."""
    rng = np.random.default_rng(23)
    vals = _scalars(rng, N_NTT)
    jmesh = JaxMesh(np.array(jax.devices()[:8]), ("x",))
    jx = jfr.from_ints(vals)
    return {
        "x": fr.from_ints(vals, "cpu"),
        False: np.asarray(jax_ntt_4step(jx, jmesh)).astype(np.int32),
        True: np.asarray(jax_ntt_4step(jx, jmesh, inverse=True)).astype(np.int32),
    }


def test_mesh_shape_axis_size_and_flat_order():
    mesh = MESHES["2x4"]()
    assert mesh.shape == {"dcn": 2, "ici": 4} and mesh.axis_names == DATA_AXES
    assert axis_size(mesh, DATA_AXES) == 8 and axis_size(mesh, "ici") == 4 and axis_size(mesh, None) == 8
    assert axis_flat_index(mesh, DATA_AXES, {"dcn": 1, "ici": 2}) == 6
    assert len(axis_devices(mesh, DATA_AXES)) == 8 and len(axis_devices(mesh, "dcn")) == 2
    with pctx.use_mesh(mesh, DATA_AXES) as ctx:
        assert ctx.num_devices == 8 and pctx.current() is ctx
    assert pctx.current() is None
    with pytest.raises(ValueError, match="no axis"):
        axis_devices(mesh, "x")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_ntts_equal_the_single_device_port_and_the_jax_package(ntt_case, mesh_name, inverse):
    mesh = MESHES[mesh_name]()
    x = ntt_case["x"]
    want = ntt_sharded.ntt_sharded_reference(x, inverse)
    assert np.array_equal(want.numpy(), ntt_case[inverse])
    assert torch.equal(ntt_sharded.ntt_4step(x, mesh, inverse=inverse), want)
    assert torch.equal(ntt_sharded.ntt_4step_resident(x, mesh, inverse=inverse), want)
    back = ntt_sharded.ntt_4step_resident(want, mesh, inverse=not inverse)
    assert torch.equal(back, x)


def test_the_ntt_router_shards_what_divides_and_passes_over_the_rest(ntt_case, monkeypatch):
    """Under a mesh, ntt/intt/ntt_many route sizes of at least
    NTT_MIN_SHARDED whose factors divide over the mesh to the four-step
    transform; three devices do not divide 16 x 16, so that size takes the
    single-device path."""
    monkeypatch.setattr(pctx, "NTT_MIN_SHARDED", 128)
    calls = []
    four_step = ntt_sharded.ntt_4step_resident
    monkeypatch.setattr(ntt_sharded, "ntt_4step_resident", lambda *a, **k: calls.append(a[0].shape) or four_step(*a, **k))
    x = ntt_case["x"]
    want = ntt.transform(x, False)
    with pctx.use_mesh(_line(3)):
        assert torch.equal(ntt.ntt(x, N_NTT), want) and not calls
    with pctx.use_mesh(_line(4)):
        assert torch.equal(ntt.ntt(x, N_NTT), want)
        assert torch.equal(ntt.intt(want), x)
        outs = ntt.ntt_many([x[:100], x[:N_NTT]], N_NTT)
        assert torch.equal(outs[1], want)
        assert ntt.intt_many([x[:64], x[64:128]])[0].shape == (64, fr.L)  # below the threshold
    assert len(calls) == 4


def _msm_case(seed, n):
    rng = np.random.default_rng(seed)
    affs = _points(rng, n)
    scal = _even_scalars(rng, n)
    return affs, scal, cd.from_affine_ints(affs, "cpu"), fr.from_ints(scal, "cpu")


@pytest.fixture
def small_thresholds(monkeypatch):
    """Ladder below 16 points a device, window blocks below 64, point
    shards from 64; sharded MSMs from 16 points."""
    monkeypatch.setattr(msm, "_PIPPENGER_MIN", 16)
    monkeypatch.setattr(msm_sharded, "WINDOW_BLOCK_MAX", 64)
    monkeypatch.setattr(pctx, "MSM_MIN_SHARDED", 16)


@pytest.mark.parametrize("body, mesh_name, axis, n", [
    ("ladder", "cpu8", None, 60),  # 8 points a device once padded to 64
    ("window_block", "cpu4", None, 128),  # 32 points a device
    ("point", "2x4", "dcn", 128),  # two shards of 64 points
])
def test_each_msm_body_equals_the_single_device_port_and_the_jax_package(
    small_thresholds, monkeypatch, body, mesh_name, axis, n
):
    affs, scal, pts, s = _msm_case(n, n)
    mesh = MESHES[mesh_name]()
    want = jhc.g1_msm(affs, scal)
    assert cd.to_affine_ints(msm.msm(pts, s)) == [want]  # the single-device port
    core = msm_sharded.msm_sharded_core
    if body == "ladder":  # through the router, which pads 60 points to 64
        sizes = []
        monkeypatch.setattr(msm_sharded, "msm_sharded_core", lambda *a, **k: sizes.append(a[0][0].shape[0]) or core(*a, **k))
        with pctx.use_mesh(mesh, axis):
            got = msm.msm(pts, s)
        assert sizes == [64] and cd.to_affine_ints(got) == [want]
        return
    got, spill = core(pts, s, mesh, axis)
    assert int(spill) == 0
    assert cd.to_affine_ints(got) == [want]


def test_a_spill_reruns_the_exact_single_device_msm(small_thresholds, monkeypatch):
    """One scalar for all 32 points: every window's entries share one
    bucket, beyond its capacity of 8, on the window-block body of two
    devices; the rerun is the single-device `msm_pippenger` with
    exact=True."""
    affs, _, pts, _ = _msm_case(7, 32)
    k = _scalars(np.random.default_rng(8), 1)[0]
    s = fr.from_ints([k] * 32, "cpu")
    reruns = []
    exact = msm.msm_pippenger
    monkeypatch.setattr(msm, "msm_pippenger", lambda *a, **kw: reruns.append(kw) or exact(*a, **kw))
    got = msm_sharded.msm_sharded(pts, s, MESHES["2x4"](), "dcn")
    assert reruns == [{"exact": True}]
    assert cd.to_affine_ints(got) == [jhc.g1_msm(affs, [k] * 32)]


def test_a_mesh_of_another_device_type_is_refused(ntt_case, small_thresholds, monkeypatch):
    """The sharded NTTs and MSM, called directly or through the routers of
    an active mesh, raise on a mesh whose devices are not of the operands'
    type instead of moving the work there."""
    monkeypatch.setattr(pctx, "NTT_MIN_SHARDED", 128)
    meta = Mesh(np.array([torch.device("meta")] * 4, dtype=object), ("x",))
    x = ntt_case["x"]
    _, _, pts, s = _msm_case(3, 16)
    calls = [lambda: ntt_sharded.ntt_4step(x, meta), lambda: ntt_sharded.ntt_4step_resident(x, meta),
             lambda: msm_sharded.msm_sharded_core(pts, s, meta)]
    for call in calls:
        with pytest.raises(ValueError, match="a mesh of"):
            call()
    with pctx.use_mesh(meta):
        with pytest.raises(ValueError, match="a mesh of"):
            ntt.ntt(x, N_NTT)
        with pytest.raises(ValueError, match="a mesh of"):
            msm.msm(pts, s)


@pytest.mark.parametrize("body, n", [("ntt", N_NTT), ("ladder", 32), ("window_block", 128), ("point", 256)])
def test_each_shard_runs_under_its_own_device(ntt_case, small_thresholds, monkeypatch, body, n):
    """The CUDA wrappers launch on the current device, so on a mesh of
    distinct cards every shard's work must run with its own card current
    (`multihost.on_device`).  Each shard-side call of the sharded NTT and
    of the three MSM bodies is recorded with the device that `on_device`
    made current; the folds and ladders are stubbed to identity points (the
    values are held by the tests above)."""
    import contextlib

    current, seen = [], []

    @contextlib.contextmanager
    def on_device(dev):
        current.append(dev)
        try:
            yield
        finally:
            current.pop()

    def under(name, fn):
        def call(*args, **kwargs):
            t = next(a[0] if isinstance(a, tuple) else a for a in args if isinstance(a, (tuple, torch.Tensor)))
            seen.append((name, t.device, current[-1] if current else None))
            return fn(*args, **kwargs)
        return call

    mesh = _line(4)
    monkeypatch.setattr(ntt_sharded, "on_device", on_device)
    monkeypatch.setattr(msm_sharded, "on_device", on_device)
    if body == "ntt":
        monkeypatch.setattr(ntt_sharded, "_along_rows", under("transform", ntt_sharded._along_rows))
        monkeypatch.setattr(fr, "mul", under("twiddle", fr.mul))
        for fn in (ntt_sharded.ntt_4step, ntt_sharded.ntt_4step_resident):
            fn(ntt_case["x"], mesh)
        want = {"transform", "twiddle"}
    else:
        def stub(pts, *args):
            return cd.identity(pts[0].shape[:-1], pts[0].device)

        def window_block(pts, scal16, c, wpd, w0):
            return cd.identity((wpd, 1), pts[0].device), torch.zeros((), dtype=torch.int64)

        def point(pts, scal16, c):
            return cd.identity((1,), pts[0].device), torch.zeros((), dtype=torch.int64)

        monkeypatch.setattr(msm_sharded.bi, "from_mont", under("from_mont", msm_sharded.bi.from_mont))
        monkeypatch.setattr(msm_sharded.cd, "scalar_mul_batch", under("ladder", stub))
        monkeypatch.setattr(msm, "pippenger_device_window_block", under("window_block", window_block))
        monkeypatch.setattr(msm, "pippenger_device", under("point", point))
        monkeypatch.setattr(msm_sharded.curve, "combine_windows", lambda w, c: cd.identity((1,), w[0].device))
        pts = cd.identity((n,), "cpu")
        pts = (pts[0], pts[1], fq.ones((n,), "cpu"))  # affine, so no normalization
        msm_sharded.msm_sharded_core(pts, fr.zeros((n,), "cpu"), mesh)
        want = {"from_mont", body}
    assert {name for name, _, _ in seen} == want
    assert all(cur is not None and dev == cur for _, dev, cur in seen), seen


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


def test_prove_under_a_mesh_gives_the_single_device_bytes(monkeypatch):
    """tests/test_marlin_sharded.py's prove cut to 64 constraints: |H| = 64
    with the NTT threshold at 64 (that test's: 256 and 128), on the 2 x 4
    mesh (both four-step factors of 64 divide by 8); the mesh is active
    inside the prove only, and the proof verifies."""
    monkeypatch.setattr(pctx, "NTT_MIN_SHARDED", 64)
    calls = []
    four_step = ntt_sharded.ntt_4step_resident
    monkeypatch.setattr(ntt_sharded, "ntt_4step_resident", lambda *a, **k: calls.append(1) or four_step(*a, **k))
    nc = 64
    circ = DummyCircuit(11, 13, num_variables=10, num_constraints=nc)
    rng = seeded_rng()
    srs = Marlin.universal_setup(nc, nc, 3 * nc, rng, device="cpu")
    pk, vk = Marlin.index(srs, circ, device="cpu")
    single = Marlin.prove(pk, circ, seeded_rng(), device="cpu")
    assert not calls
    sharded = Marlin.prove(pk, circ, seeded_rng(), device="cpu", mesh=MESHES["2x4"]())
    assert calls and pctx.current() is None
    assert sharded.to_bytes() == single.to_bytes()
    assert Marlin.verify(vk, [11 * 13 % R], sharded, seeded_rng(), device="cpu")
    with pytest.raises(ValueError, match="a mesh of"):
        Marlin.prove(pk, circ, seeded_rng(), device="cpu", mesh=Mesh(np.array(["meta"] * 2, dtype=object), ("x",)))
