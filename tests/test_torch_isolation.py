"""Package rules of the port (marlin_tpu_torch), checked on the CPU.

* it imports neither JAX nor anything of the JAX package `marlin_tpu`;
* on CPU tensors no CUDA kernel is launched (the launch counters stay 0):
  a CPU tensor takes the plain version, and only because of its device;
* an entry point given no device asks for the card and raises on a machine
  without one — nothing falls back to the CPU quietly.
"""

import os
import subprocess
import sys

import pytest
import torch

from marlin_tpu_torch.ops import cuda, fr, ntt
from marlin_tpu_torch.snark.marlin import Marlin
from marlin_tpu_torch.snark.r1cs import lc
from marlin_tpu_torch.utils.rand import test_rng as seeded_rng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class OneConstraint:
    def generate_constraints(self, cs):
        x = cs.new_witness_variable(lambda: 3)
        y = cs.new_witness_variable(lambda: 5)
        out = cs.new_input_variable(lambda: 15)
        cs.enforce_constraint(lc(x), lc(y), lc(out))


@pytest.fixture(scope="module")
def cpu_keys():
    rng = seeded_rng()
    srs = Marlin.universal_setup(32, 32, 96, rng, device="cpu")
    pk, vk = Marlin.index(srs, OneConstraint(), device="cpu")
    return srs, pk, vk


def test_package_imports_neither_jax_nor_marlin_tpu():
    code = (
        "import sys, marlin_tpu_torch, marlin_tpu_torch.interop\n"
        "from marlin_tpu_torch.snark.marlin import Marlin\n"
        "import marlin_tpu_torch.ops.mont, marlin_tpu_torch.ops.msm\n"
        "import marlin_tpu_torch.snark.serial\n"
        "import marlin_tpu_torch.parallel.context, marlin_tpu_torch.parallel.multihost\n"
        "import marlin_tpu_torch.parallel.ntt_sharded, marlin_tpu_torch.parallel.msm_sharded\n"
        "import marlin_tpu_torch.parallel.collectives\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('pregen', 'tools/torch_pregen_caches.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'marlin_tpu' or m.startswith('marlin_tpu.'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_cpu_tensors_launch_no_kernel(cpu_keys, tmp_path):
    from marlin_tpu_torch.parallel import context as pctx
    from marlin_tpu_torch.parallel.multihost import make_mesh
    from marlin_tpu_torch.snark import serial

    srs, pk, vk = cpu_keys
    cuda.reset_launches()
    x = fr.from_ints(list(range(1, 65)), "cpu")
    fr.inv(fr.mul(x, x))
    ntt.intt(ntt.ntt(x, 64))
    serial.save_srs(srs, str(tmp_path / "srs.npz"))
    serial.load_srs(str(tmp_path / "srs.npz"), device="cpu")
    with pctx.use_mesh(make_mesh(devices=[torch.device("cpu")] * 4)):
        ntt.intt(ntt.ntt(fr.from_ints(list(range(1, 4097)), "cpu"), 4096))
    proof = Marlin.prove(pk, OneConstraint(), seeded_rng(), device="cpu")
    assert Marlin.verify(vk, [15], proof, seeded_rng(), device="cpu")
    assert all(v == 0 for v in cuda.LAUNCHES.values()), cuda.LAUNCHES
    assert not cuda.BINOP_LAUNCHES


def test_kernel_wrappers_refuse_cpu_tensors():
    from marlin_tpu_torch.ops import bigint as bi

    x = fr.from_ints([1, 2, 3, 4], "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        bi.binop_kernel("mul", fr.CTX, x, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bi.inv_kernel(fr.CTX, x)


@pytest.mark.parametrize("entry", [
    "setup", "index", "prove", "verify",
    "load_srs", "load_index_pk", "load_index_vk", "cached_srs", "make_mesh",
])
def test_entry_points_without_device_need_the_card(cpu_keys, entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device is valid here")
    from marlin_tpu_torch.parallel.multihost import make_mesh
    from marlin_tpu_torch.snark import serial

    srs, pk, vk = cpu_keys
    path = str(tmp_path / "archive.npz")
    calls = {
        "setup": lambda: Marlin.universal_setup(32, 32, 96, seeded_rng()),
        "index": lambda: Marlin.index(srs, OneConstraint()),
        "prove": lambda: Marlin.prove(pk, OneConstraint(), seeded_rng()),
        "verify": lambda: Marlin.verify(vk, [15], None, seeded_rng()),
        "load_srs": lambda: serial.save_srs(srs, path) or serial.load_srs(path),
        "load_index_pk": lambda: serial.save_index_pk(pk, path) or serial.load_index_pk(path),
        "load_index_vk": lambda: serial.save_index_vk(vk, path) or serial.load_index_vk(path),
        "cached_srs": lambda: serial.cached_srs(40, seeded_rng(), cache_dir=str(tmp_path)),
        "make_mesh": lambda: make_mesh(),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_keys_on_another_device_are_not_moved(cpu_keys):
    _srs, pk, _vk = cpu_keys
    with pytest.raises(ValueError, match="lives on cpu"):
        Marlin.prove(pk, OneConstraint(), seeded_rng(), device="meta")


@pytest.mark.parametrize("curve", ["bn254", "bls12_377", "synthetic_lowadic"])
def test_other_curves_import_no_jax_and_prove_on_the_cpu_without_kernels(curve):
    """Under another curve the package's new modules (the curve configs, the
    generic tower and pairing, the mixed-radix NTT) import nothing of JAX,
    a CPU prove launches no kernel, and a mixed-radix transform of CPU
    tensors is counted as the host's."""
    code = (
        "import sys\n"
        "from marlin_tpu_torch.fields import active as P, curve_generic, pairing_generic, host_pairing\n"
        "from marlin_tpu_torch import interop\n"
        "from marlin_tpu_torch.ops import cuda, fr, ntt\n"
        "from marlin_tpu_torch.snark.marlin import Marlin\n"
        "from marlin_tpu_torch.snark.r1cs import lc\n"
        "from marlin_tpu_torch.utils.rand import test_rng\n"
        f"assert P.CURVE_NAME == {curve!r} and fr.CTX.curve == P.CURVE_NAME\n"
        "class C:\n"
        "    def generate_constraints(self, cs):\n"
        "        x = cs.new_witness_variable(lambda: 3)\n"
        "        y = cs.new_witness_variable(lambda: 5)\n"
        "        out = cs.new_input_variable(lambda: 15)\n"
        "        cs.enforce_constraint(lc(x), lc(y), lc(out))\n"
        "rng = test_rng()\n"
        "srs = Marlin.universal_setup(32, 32, 96, rng, device='cpu')\n"
        "pk, vk = Marlin.index(srs, C(), device='cpu')\n"
        "proof = Marlin.prove(pk, C(), rng, device='cpu')\n"
        "assert Marlin.verify(vk, [15], proof, rng, device='cpu')\n"
        "x = fr.from_ints(list(range(1, 25)), 'cpu')\n"
        "assert ntt.intt(ntt.transform(x, False)).equal(x) and ntt.MIXED_TRANSFORMS['cpu'] == 2\n"
        "assert all(v == 0 for v in cuda.LAUNCHES.values()), cuda.LAUNCHES\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'marlin_tpu' or m.startswith('marlin_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, MARLIN_TPU_CURVE=curve)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


_WIDE750_PROG = r"""
import sys
from marlin_tpu_torch import interop
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.ops import cuda, fr, ntt, poly, sparse
from marlin_tpu_torch.snark import ahp, constraint_systems, domains, fs, indexer, lc, prover, verifier
from marlin_tpu_torch.snark.r1cs import lc as lin

assert P.CURVE_NAME == "test_wide750" and fr.L == 48 and fr.CTX.curve == "test_wide750"
R = P.R_MODULUS


class C:
    def generate_constraints(self, cs):
        a = cs.new_witness_variable(lambda: 3)
        b = cs.new_witness_variable(lambda: 5)
        c = cs.new_input_variable(lambda: 15)
        for _ in range(7):
            cs.new_witness_variable(lambda: 3)
        for _ in range(63):
            cs.enforce_constraint(lin(a), lin(b), lin(c))
        cs.enforce_constraint(lin(), lin(), lin())


from marlin_tpu_torch.utils.rand import test_rng

rng = test_rng()
idx = indexer.index_circuit(C(), "cpu")
assert (idx.domain_h.size, idx.domain_k.size) == (72, 216), (idx.domain_h.size, idx.domain_k.size)
state = prover.prover_init(idx, C())
public_input = state.public_input()
t = fs.FiatShamirRng(b"MARLIN-2019-wide750" + idx.index_info.to_bytes())
first, state = prover.prover_first_round(state, rng)
v1, vs = verifier.verifier_first_round(idx.index_info, t)
second, state = prover.prover_second_round(v1, state, rng)
v2, vs = verifier.verifier_second_round(vs, t)
third = prover.prover_third_round(v2, state, rng)
vs = verifier.verifier_third_round(vs, t)
polys = {label: prover.LabeledPoly(label, c, b, None) for label, c, b in idx.iter_polys()}
polys.update({**first, **second, **third})
query_set, vs = verifier.verifier_query_set(vs)
provider = lc.PolyEvaluationsProvider(polys)
lcs = lc.construct_linear_combinations(public_input, provider, vs)
zero = [int(provider.get_lc_eval(next(l for l in lcs if l.label == label), point))
        for label, (_pl, point) in query_set if label in ahp.LC_WITH_ZERO_EVAL]
assert zero == [0, 0], zero
assert ntt.MIXED_TRANSFORMS["cpu"] > 0 and ntt.MIXED_TRANSFORMS["cuda"] == 0
assert all(v == 0 for v in cuda.LAUNCHES.values()), cuda.LAUNCHES
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "marlin_tpu" or m.startswith("marlin_tpu."))
assert not bad, bad
pc = sorted(m for m in sys.modules if m.startswith("marlin_tpu_torch.")
            and m.rsplit(".", 1)[-1] in ("fq", "kzg", "sonic", "curve", "curve_device", "msm"))
assert not pc, pc
print("OK", flush=True)
"""


def test_test_wide750_runs_its_ahp_on_the_cpu_without_jax_or_the_pc_layer():
    """Under the 750-bit field with no curve, the AHP's modules and
    `interop` import with nothing of JAX and nothing of the PC layer or the
    group (ops.fq, kzg, sonic, curve), and the AHP at 2^6 constraints on
    mixed domains (under MARLIN_TPU_FR_TWO_ADICITY_CAP=5) runs on CPU
    tensors with both sumcheck combinations 0 and no kernel launched."""
    env = dict(os.environ, MARLIN_TPU_CURVE="test_wide750", MARLIN_TPU_FR_TWO_ADICITY_CAP="5")
    res = subprocess.run([sys.executable, "-c", _WIDE750_PROG], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "OK" in res.stdout


def test_test_wide750_source_plan_names_no_curve_kernel():
    """test_wide750's library builds the field and NTT kernels only, and its
    loader binds no entry of the group's sources."""
    srcs = cuda.sources("test_wide750")
    assert set(srcs) == {"field.cu", "ntt.cu", "imad.cu"}
    assert "test_wide750" in cuda.CURVE_IDS and "test_wide750" in cuda.FIELD_ONLY
    bound = {name for src in srcs for name in cuda._SIGNATURES[src]}
    assert not any(n.startswith(("marlin_g1_", "marlin_bucket", "marlin_combine")) for n in bound), bound
    for curve in cuda.CURVE_IDS:
        if curve not in cuda.FIELD_ONLY:
            assert {"curve.cu", "chain.cu"} <= set(cuda.sources(curve))


def test_interop_refuses_an_srs_of_another_curve():
    import numpy as np

    from marlin_tpu_torch import interop
    from marlin_tpu_torch.ops import fq

    other = np.zeros((4, 16 if fq.L == 24 else 24), np.int32)  # another curve's Fq width
    with pytest.raises(ValueError, match="limbs"):
        interop.universal_params({"powers_of_g": (other, other, other)}, "cpu")
