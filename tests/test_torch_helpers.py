"""The JAX package's last helpers in the port, on the CPU.

Each is held against its counterpart in `marlin_tpu` on the same limbs,
made from a numpy seed (edge values 0, 1, N-2 and N-1 first):

* `ops/fr.py`: `neg`, `pow_const`, `is_zero`, `eq`;
* `ops/fq.py`: `sqr`, `is_zero`, `eq`, `select`;
* `ops/bigint.py`: `mul_wide`, `cond_sub_modulus`, `mont_reduce`,
  `mont_sqr`, `is_zero`, `eq`, for Fr and for Fq;
* `ops/poly.py`: `evaluate_many`, and `degree` on a trimmed vector, on one
  with zero rows at its top and on the zero polynomial;
* `ops/msm.py::_fixed_c` with and without MARLIN_TPU_FIXED_C, and the
  table size that `snark/kzg.py::msm_table_mb` derives from it.

Then the diff of the two packages' public names, module by module: only
`parallel/ntt_sharded.py::block_sharding` (a JAX `NamedSharding`) has no
counterpart in the port.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import marlin_tpu
from marlin_tpu.ops import bigint as jbi
from marlin_tpu.ops import fq as jfq
from marlin_tpu.ops import fr as jfr
from marlin_tpu.ops import msm as jmsm
from marlin_tpu.ops import poly as jpoly
from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import fq, fr, msm, poly
from marlin_tpu_torch.snark import kzg

FIELDS = {"fr": (jfr, fr), "fq": (jfq, fq)}


def _limbs(field: str, n: int, seed: int) -> tuple:
    """(JAX array, port tensor) of the same n Montgomery elements."""
    jm, m = FIELDS[field]
    rng = np.random.default_rng(seed)
    mod = m.CTX.modulus
    vals = [0, 1, mod - 2, mod - 1] + [int.from_bytes(rng.bytes(64), "little") % mod for _ in range(n - 4)]
    return jm.from_ints(vals), m.from_ints(vals, "cpu")


def _same(jax_out, torch_out) -> bool:
    return np.array_equal(np.asarray(jax_out).astype(np.int64), torch_out.numpy().astype(np.int64))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_field_helpers_equal_the_jax_package(field):
    jm, m = FIELDS[field]
    ja, a = _limbs(field, 12, 1)
    jb, b = ja[::-1], a.flip(0)
    jb_eq, b_eq = ja.at[3].set(jb[3]), a.clone()
    b_eq[3] = b[3]
    assert _same(jm.neg(ja), m.neg(a))
    assert _same(jm.sqr(ja), m.sqr(a))
    assert _same(jm.is_zero(ja), m.is_zero(a))
    assert _same(jm.eq(ja, jb_eq), m.eq(a, b_eq)) and m.eq(a, b_eq).sum() == 11
    cond = np.arange(12) % 3 == 0
    assert _same(jm.select(cond, ja, jb), m.select(torch.as_tensor(cond), a, b))
    if field == "fr":
        for e in (0, 5, fr.CTX.modulus - 2):
            assert _same(jfr.pow_const(ja, e), fr.pow_const(a, e)), e


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_bigint_helpers_equal_the_jax_package(field):
    jm, m = FIELDS[field]
    ja, a = _limbs(field, 12, 2)
    jb, b = ja[::-1], a.flip(0)
    jw, w = jbi.mul_wide(ja, jb), bi.mul_wide(a, b)
    assert _same(jw, w)  # the redundant limbs, before any carry
    jt, t = jbi.normalize(jw), bi.normalize(w)
    assert _same(jt, t)
    assert _same(jbi.mont_reduce(jm.CTX, jt), bi.mont_reduce(m.CTX, t))
    assert _same(jbi.mont_sqr(jm.CTX, ja), bi.mont_sqr(m.CTX, a))
    jtwice = jbi.normalize(ja + ja, jm.CTX.L + 1)  # [0, 2N)
    twice = bi.normalize(a.to(torch.int64) * 2, m.CTX.L + 1)
    assert _same(jtwice, twice)
    assert _same(jbi.cond_sub_modulus(jm.CTX, jtwice), bi.cond_sub_modulus(m.CTX, twice))
    assert _same(jbi.is_zero(jm.CTX, ja), bi.is_zero(m.CTX, a))
    assert _same(jbi.eq(jm.CTX, ja, jb), bi.eq(m.CTX, a, b))


def test_poly_evaluate_many_and_degree_equal_the_jax_package():
    jp, p = _limbs("fr", 9, 3)
    jzs, zs = _limbs("fr", 5, 4)
    got = poly.evaluate_many(p, list(zs.unbind(0)))
    want = jpoly.evaluate_many(jp, [jzs[i] for i in range(5)])
    assert len(got) == 5 and all(_same(j, t) for j, t in zip(want, got))
    padded, jpadded = torch.cat([p, fr.zeros((3,))]), jpoly.pad_to(jp, 12)
    for jv, v in ((jp, p), (jpadded, padded), (jp[:1], p[:1]), (jp[:1] * 0, p[:1] * 0)):
        assert poly.degree(v) == jpoly.degree(jv)
    assert poly.degree(padded) == 8 and poly.degree(p[:1] * 0) == -1


@pytest.mark.parametrize("fixed_c", [None, "8", "12"])
def test_the_window_width_follows_the_override(monkeypatch, fixed_c):
    if fixed_c is None:
        monkeypatch.delenv("MARLIN_TPU_FIXED_C", raising=False)
    else:
        monkeypatch.setenv("MARLIN_TPU_FIXED_C", fixed_c)
    for log_n in range(8, 21):
        c = msm._fixed_c(1 << log_n)
        assert c == jmsm._fixed_c(1 << log_n) == (int(fixed_c) if fixed_c else c)
        assert kzg.msm_table_mb(1 << log_n) == msm.fixed_table_windows(c) * (1 << log_n) * 96 / 1e6


def _public_names(module) -> list:
    """Functions, classes and other callables a module defines itself."""
    return [name for name, obj in vars(module).items()
            if not name.startswith("_") and callable(obj) and not inspect.ismodule(obj)
            and not inspect.isbuiltin(obj) and getattr(obj, "__module__", None) in (module.__name__, None)]


def test_only_block_sharding_lacks_a_counterpart_in_the_port():
    missing = {}
    for info in pkgutil.walk_packages(marlin_tpu.__path__, "marlin_tpu."):
        if ".pallas" in info.name:  # the TPU kernels: ported as CUDA sources
            continue
        jmod = importlib.import_module(info.name)
        port = importlib.import_module(info.name.replace("marlin_tpu.", "marlin_tpu_torch.", 1))
        lacking = [name for name in _public_names(jmod) if not hasattr(port, name)]
        if lacking:
            missing[info.name] = lacking
    assert missing == {"marlin_tpu.parallel.ntt_sharded": ["block_sharding"]}
