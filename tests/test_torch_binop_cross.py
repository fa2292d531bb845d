"""Kernel 1's row maps and kernel 3(b)'s stage groups, on the CPU, against
the JAX package.

* The row-map planner (`bigint.row_map`): for every broadcast the main path
  hands kernel 1 (a [1, L] scalar against [n, L], `poly.evaluate_batch`'s
  [1, len, L] powers against [m, len, L], a [k, 1, L] column, the mixed
  NTT's W, M and v[:, None]), the rows its map reads (`rows_by_map`, the
  plain version of the kernel's read) equal the materialized broadcast; a
  broadcast no map expresses is made to the full shape and counted.
* The plain binop on broadcast operands, and on the rows the maps read,
  against `marlin_tpu.ops.fr.mul` / `add` / `sub` on the same inputs.
* The stage-group planner (`ntt.cross_groups`): for n = 2^1 .. 2^22, every
  in-block size and the mixed-radix inner transforms, at 8 and 24 words,
  every stage from log_b to log_n - 1 lands in exactly one group and every
  group's tile fits kernel 3(b)'s shared-memory budget.
* Transforms built from `cross_stages_plain` with a small block (so that
  the groups split) against the JAX package's `ntt` / `intt` at 2^12 and
  2^13, forward and inverse; and the same at 24 words, with the broadcast
  binops, in a subprocess under `MARLIN_TPU_CURVE=test_wide750`.

The JAX side runs in subprocesses started together, so this process
compiles nothing with XLA.  Exact equality throughout (tolerance 0): the
arithmetic is exact and both packages return canonical residues.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import cuda, fr, ntt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = fr.CTX.modulus
KINDS = ("mul", "add", "sub")

# (operand batch shape, launch batch shape): the broadcasts of the main
# path (snark/prover.py, ops/poly.py, ops/ntt.py::_mixed) and a few more
MAPPED = {
    "scalar [1] vs [n] (alpha, coeffs_abc[k], scale, z2j, zinv)": ((1,), (64,)),
    "bare scalar [] vs [n]": ((), (64,)),
    "powers [1, len] vs [m, len] (evaluate_batch)": ((1, 33), (3, 33)),
    "column [k, 1] vs [k, m]": ((4, 1), (4, 9)),
    "mixed W [n1, n2] vs [1, n1, n2]": ((3, 8), (1, 3, 8)),
    "mixed W [n1, n2] vs [2, n1, n2]": ((3, 8), (2, 3, 8)),
    "mixed M [n1, n1, 1] vs [1, n1, n1, n2]": ((3, 3, 1), (1, 3, 3, 8)),
    "mixed v [1, 1, n1, n2] vs [1, n1, n1, n2]": ((1, 1, 3, 8), (1, 3, 3, 8)),
    "no broadcast": ((5, 7), (5, 7)),
}
UNMAPPED = {"[2, 1, 3] vs [2, 5, 3]": ((2, 1, 3), (2, 5, 3)),
            "[3, 1, 1, 2] vs [3, 2, 2, 2]": ((3, 1, 1, 2), (3, 2, 2, 2))}
# the broadcast binops held against the JAX package: (a shape, b shape)
BINOP_CASES = {
    "scalar": ((40,), (1,)),
    "powers": ((3, 11), (1, 11)),
    "column": ((4, 1), (4, 6)),
    "mixed M": ((1, 1, 3, 4), (3, 3, 1)),
}
# the transforms held against the JAX package: (log_n, block_log2), each
# with its cross stages split over two groups
GROUPED = [(12, 3), (12, 4), (13, 3), (13, 4)]


def _ints(n: int, seed: int, modulus: int = R) -> list:
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(100), "little") % modulus for _ in range(n)]
    edges = [0, 1, modulus - 1][:n]
    vals[: len(edges)] = edges
    return vals


def _limbs(shape, seed: int) -> torch.Tensor:
    n = int(np.prod(shape)) if shape else 1
    return fr.from_ints(_ints(n, seed), "cpu").reshape(*shape, fr.L)


def _inputs() -> dict:
    binops = {name: (sa, sb, _ints(int(np.prod(sa)), 10 + i), _ints(int(np.prod(sb)), 20 + i))
              for i, (name, (sa, sb)) in enumerate(BINOP_CASES.items())}
    vecs = {log_n: _ints(1 << log_n, log_n) for log_n, _ in GROUPED}
    return {"binops": binops, "vecs": vecs}


_JAX_SIDE = r"""
import pickle, sys
import numpy as np
from marlin_tpu.ops import fr, ntt

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
out = {"binops": {}, "ntt": {}}
for name, (sa, sb, xa, xb) in inp["binops"].items():
    a = fr.from_ints(xa).reshape(*sa, fr.L)
    b = fr.from_ints(xb).reshape(*sb, fr.L)
    out["binops"][name] = {k: np.asarray(getattr(fr, k)(a, b)) for k in ("mul", "add", "sub")}
for log_n, xs in inp["vecs"].items():
    x = fr.from_ints(xs)
    out["ntt"][log_n] = (np.asarray(ntt.ntt(x, 1 << log_n)), np.asarray(ntt.intt(x)))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""

# test_wide750 (24 words): both packages in one process under the curve
_WIDE_SIDE = r"""
import json, sys
import numpy as np
import torch
from marlin_tpu.ops import fr as jfr, ntt as jntt
from marlin_tpu_torch.fields import active as P
from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import fr, ntt

assert P.CURVE_NAME == "test_wide750" and fr.L == 48
R = P.R_MODULUS
rng = np.random.default_rng(750)
res = {}


def values(n):
    vals = [int.from_bytes(rng.bytes(100), "little") % R for _ in range(n)]
    return [0, 1, R - 1][:n] + vals[3:]


def same(t, j):
    return np.array_equal(t.numpy().astype(np.int64), np.asarray(j).astype(np.int64))


for name, (sa, sb) in (("scalar", ((40,), (1,))), ("column", ((4, 1), (4, 6)))):
    a = fr.from_ints(values(int(np.prod(sa))), "cpu").reshape(*sa, fr.L)
    b = fr.from_ints(values(int(np.prod(sb))), "cpu").reshape(*sb, fr.L)
    shape = torch.broadcast_shapes(sa, sb)
    n = int(np.prod(shape))
    rows = [bi.rows_by_map(t, bi.row_map(t.shape[:-1], shape), n) for t in (a, b)]
    ja = jfr.from_ints(fr.to_ints(a.reshape(-1, fr.L))).reshape(*sa, fr.L)
    jb = jfr.from_ints(fr.to_ints(b.reshape(-1, fr.L))).reshape(*sb, fr.L)
    for k in ("mul", "add", "sub"):
        ref = getattr(jfr, k)(ja, jb)
        res[f"binop {k} {name}"] = bool(same(bi.PLAIN_OPS[k](fr.CTX, a, b), ref)
                                        and same(bi.PLAIN_OPS[k](fr.CTX, *rows).reshape(*shape, fr.L), ref))
log_n, block = 12, 3
groups = ntt.cross_groups(log_n, block)
res["groups split"] = len(groups) == 2
xs = values(1 << log_n)
x = fr.from_ints(xs, "cpu")
jx = jfr.from_ints(xs)
for inverse, ref in ((False, jntt.ntt(jx, 1 << log_n)), (True, jntt.intt(jx))):
    got = ntt.transform(x, inverse, plain=True, block_log2=block)
    res[f"{'intt' if inverse else 'ntt'} 2^{log_n}, block 2^{block}"] = bool(same(got, ref))
print("RESULT " + json.dumps(res), flush=True)
"""

WIDE_KEYS = ([f"binop {k} {name}" for name in ("scalar", "column") for k in KINDS]
             + ["groups split", "ntt 2^12, block 2^3", "intt 2^12, block 2^3"])


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's results: BLS12-381's binops and transforms, and
    test_wide750's checks, from two subprocesses run side by side."""
    tmp = tmp_path_factory.mktemp("jax_binop_cross")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(_inputs(), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", MARLIN_TPU_XLA_CACHE="", TF_CPP_MIN_LOG_LEVEL="3",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("MARLIN_TPU_CURVE", None)
    env.pop("MARLIN_TPU_FR_TWO_ADICITY_CAP", None)
    bls = subprocess.Popen([sys.executable, "-c", _JAX_SIDE, str(tmp / "in.pkl"), str(tmp / "out.pkl")],
                           cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    wide = subprocess.Popen([sys.executable, "-c", _WIDE_SIDE], cwd=ROOT,
                            env=dict(env, MARLIN_TPU_CURVE="test_wide750"),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out_b, err_b = bls.communicate(timeout=600)
    out_w, err_w = wide.communicate(timeout=600)
    assert bls.returncode == 0, err_b[-4000:]
    assert wide.returncode == 0, out_w[-2000:] + err_w[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    line = [ln for ln in out_w.splitlines() if ln.startswith("RESULT ")][-1]
    ref["wide"] = json.loads(line[len("RESULT "):])
    return _inputs(), ref


def _same(t: torch.Tensor, ref) -> bool:
    return np.array_equal(t.numpy().astype(np.int64), np.asarray(ref).astype(np.int64))


# --------------------------------------------------------------------------
# (a) kernel 1's row maps


@pytest.mark.parametrize("case", list(MAPPED))
def test_row_map_reads_the_materialized_broadcast(case):
    shape, out_shape = MAPPED[case]
    t = _limbs(shape, 3)
    m = bi.row_map(shape, out_shape)
    assert m is not None
    n = int(np.prod(out_shape))
    full = t.expand(*out_shape, fr.L).reshape(n, fr.L)
    assert torch.equal(bi.rows_by_map(t, m, n), full)


@pytest.mark.parametrize("case", list(UNMAPPED))
def test_a_broadcast_no_map_expresses_is_materialized_and_counted(case):
    shape, out_shape = UNMAPPED[case]
    assert bi.row_map(shape, out_shape) is None
    t = _limbs(shape, 4)
    cuda.reset_launches()
    got, m = bi._binop_operand(t, out_shape)
    assert cuda.BINOP_COPIES == {"broadcast": 1, "layout": 0}
    assert m == bi.IDENTITY_MAP and torch.equal(got, t.expand(*out_shape, fr.L))
    cuda.reset_launches()


def test_mapped_operands_are_read_in_place_and_strided_ones_copied():
    t = _limbs((4, 1), 5)
    cuda.reset_launches()
    got, m = bi._binop_operand(t, (4, 9))
    assert got is t and m == (9, 4)
    assert cuda.BINOP_COPIES == {"broadcast": 0, "layout": 0}
    strided = _limbs((6, 4), 6)[:, 1]  # a column: not contiguous
    got, m = bi._binop_operand(strided, (6,))
    assert cuda.BINOP_COPIES == {"broadcast": 0, "layout": 1}
    assert got.is_contiguous() and torch.equal(got, strided) and m == bi.IDENTITY_MAP
    cuda.reset_launches()


@pytest.mark.parametrize("case", list(BINOP_CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_plain_binop_on_broadcast_operands_matches_jax(jax_side, kind, case):
    """The plain op on the broadcast operands, and on the rows their maps
    read (what kernel 1 reads), against the JAX package's op."""
    inp, ref = jax_side
    sa, sb = BINOP_CASES[case]
    xa, xb = inp["binops"][case][2:]
    a = fr.from_ints(xa, "cpu").reshape(*sa, fr.L)
    b = fr.from_ints(xb, "cpu").reshape(*sb, fr.L)
    shape = torch.broadcast_shapes(sa, sb)
    n = int(np.prod(shape))
    want = ref["binops"][case][kind]
    assert _same(bi.PLAIN_OPS[kind](fr.CTX, a, b), want)
    rows = [bi.rows_by_map(t, bi.row_map(t.shape[:-1], shape), n) for t in (a, b)]
    assert _same(bi.PLAIN_OPS[kind](fr.CTX, *rows).reshape(*shape, fr.L), want)


# --------------------------------------------------------------------------
# (b) kernel 3(b)'s stage groups


def _check_groups(log_n: int, log_b: int, L: int) -> list:
    groups = ntt.cross_groups(log_n, log_b, L)
    covered = [s for s0, s1 in groups for s in range(s0, s1)]
    assert covered == list(range(log_b, log_n)), (log_n, log_b, groups)
    for s0, s1 in groups:
        rows, width = 1 << (s1 - s0), min(8, 1 << s0)
        assert rows * width * 4 * L <= ntt.CROSS_SMEM_BYTES, (log_n, log_b, s0, s1)
    return groups


@pytest.mark.parametrize("log_n", range(1, 23))
@pytest.mark.parametrize("L", [16, 48], ids=["8 words", "24 words"])
def test_cross_groups_cover_every_stage_and_fit(L, log_n):
    for log_b in range(1, min(log_n, ntt.BLOCK_LOG2) + 1):
        _check_groups(log_n, log_b, L)


@pytest.mark.parametrize("L", [16, 48], ids=["8 words", "24 words"])
def test_cross_groups_of_the_mixed_inner_transforms(L):
    """The inner radix-2 transforms of the mixed domains (3^s 2^11 for
    synthetic_lowadic and test_wide750, 81 x 2^9 for test_wide750): one
    group of one stage, or none inside the block."""
    for n in (3 << 11, 9 << 11, 27 << 11, 81 << 9, 3 << 13):
        log_n2 = (n & -n).bit_length() - 1  # n2, the power of two in n
        groups = _check_groups(log_n2, min(log_n2, ntt.BLOCK_LOG2), L)
        assert groups == ([(10, log_n2)] if log_n2 > 10 else [])


@pytest.mark.parametrize("log_n", range(11, 18))
def test_a_prove_transform_takes_one_cross_launch(log_n):
    """Every transform of the 2^14 prove (2^14 - 2^17 points) runs its
    cross stages in one launch at 8 words, and 2^16 at 24 words."""
    assert ntt.cross_groups(log_n, ntt.BLOCK_LOG2) == [(ntt.BLOCK_LOG2, log_n)]
    if log_n <= 16:
        assert ntt.cross_groups(log_n, ntt.BLOCK_LOG2, 48) == [(ntt.BLOCK_LOG2, log_n)]


# --------------------------------------------------------------------------
# (c) transforms from the grouped plain stages


def test_cross_stages_plain_over_split_groups_is_one_pass():
    """The stages of a split plan, a group at a time, equal the same stages
    in one pass."""
    x = _limbs((1 << 12,), 7)
    tw, _ = ntt._plan_tensors(1 << 12, False, torch.device("cpu"))
    groups = ntt.cross_groups(12, 3)
    assert groups == [(3, 10), (10, 12)]
    y = x
    for s0, s1 in groups:
        y = ntt.cross_stages_plain(y, tw, s0, s1)
    assert torch.equal(y, ntt.cross_stages_plain(x, tw, 3, 12))


@pytest.mark.parametrize("log_n, block_log2", GROUPED)
@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
def test_grouped_transform_matches_jax(jax_side, log_n, block_log2, inverse):
    inp, ref = jax_side
    assert len(ntt.cross_groups(log_n, block_log2)) == 2
    x = fr.from_ints(inp["vecs"][log_n], "cpu")
    got = ntt.transform(x, inverse, plain=True, block_log2=block_log2)
    assert _same(got, ref["ntt"][log_n][int(inverse)])


# --------------------------------------------------------------------------
# (d) the same at 24 words (test_wide750)


@pytest.mark.parametrize("check", WIDE_KEYS)
def test_wide750_grouped_transform_and_broadcast_binops_match_jax(jax_side, check):
    _, ref = jax_side
    assert ref["wide"].get(check) is True, ref["wide"]
