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
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'marlin_tpu' or m.startswith('marlin_tpu.'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_cpu_tensors_launch_no_kernel(cpu_keys):
    _srs, pk, vk = cpu_keys
    cuda.reset_launches()
    x = fr.from_ints(list(range(1, 65)), "cpu")
    fr.inv(fr.mul(x, x))
    ntt.intt(ntt.ntt(x, 64))
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


@pytest.mark.parametrize("entry", ["setup", "index", "prove", "verify"])
def test_entry_points_without_device_need_the_card(cpu_keys, entry):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default device is valid here")
    srs, pk, vk = cpu_keys
    calls = {
        "setup": lambda: Marlin.universal_setup(32, 32, 96, seeded_rng()),
        "index": lambda: Marlin.index(srs, OneConstraint()),
        "prove": lambda: Marlin.prove(pk, OneConstraint(), seeded_rng()),
        "verify": lambda: Marlin.verify(vk, [15], None, seeded_rng()),
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


def test_test_wide750_is_not_ported_yet():
    env = dict(os.environ, MARLIN_TPU_CURVE="test_wide750")
    res = subprocess.run([sys.executable, "-c", "import marlin_tpu_torch.ops.fr"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "NotImplementedError" in res.stderr and "test_wide750" in res.stderr


def test_interop_refuses_an_srs_of_another_curve():
    import numpy as np

    from marlin_tpu_torch import interop
    from marlin_tpu_torch.ops import fq

    other = np.zeros((4, 16 if fq.L == 24 else 24), np.int32)  # another curve's Fq width
    with pytest.raises(ValueError, match="limbs"):
        interop.universal_params({"powers_of_g": (other, other, other)}, "cpu")
