"""The port's CUDA kernels against their plain versions, on the card.

Marked `gpu`: each test skips where no CUDA device is present.  On the H100
they run with (the suite's conftest imports JAX, which that machine lacks):

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_cuda.py

Exact equality throughout: the kernels and the plain versions compute the
same canonical residues.
"""

import numpy as np
import pytest
import torch

from marlin_tpu_torch.ops import bigint as bi
from marlin_tpu_torch.ops import cuda, fq, fr, ntt

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _elements(ctx, n, seed, dev):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(56), "little") % ctx.modulus for _ in range(n)]
    edges = [0, 1, ctx.modulus - 2, ctx.modulus - 1][:n]
    vals[: len(edges)] = edges
    mod = fr if ctx is fr.CTX else fq
    return mod.from_ints(vals, dev)


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("kind", ["mul", "add", "sub"])
def test_binop_kernel_matches_plain(dev, field, kind):
    ctx = {"fr": fr.CTX, "fq": fq.CTX}[field]
    a, b = _elements(ctx, 3000, 1, dev), _elements(ctx, 3000, 2, dev).flip(0)
    plain = {"mul": bi.mont_mul, "add": bi.add_mod, "sub": bi.sub_mod}[kind]
    assert torch.equal(bi.binop_kernel(kind, ctx, a, b), plain(ctx, a, b))


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_inv_kernel_matches_plain(dev, field):
    ctx = {"fr": fr.CTX, "fq": fq.CTX}[field]
    x = _elements(ctx, 300, 3, dev)
    assert torch.equal(bi.inv_kernel(ctx, x), bi.inv_mod(ctx, x))


@pytest.mark.parametrize("shape", [(2,), (1 << 10,), (1 << 13,), (3, 1 << 11)])
def test_ntt_kernels_match_plain_twins(dev, shape):
    x = _elements(fr.CTX, int(np.prod(shape)), 4, dev).reshape(*shape, fr.L)
    for inverse in (False, True):
        assert torch.equal(ntt.transform(x, inverse), ntt.transform(x, inverse, plain=True))


def test_cuda_routing_counts_launches(dev):
    cuda.reset_launches()
    x = _elements(fr.CTX, 64, 5, dev)
    fr.inv(fr.mul(x, x))
    ntt.ntt(x, 1 << 11)
    assert cuda.LAUNCHES["field_binop"] >= 1 and cuda.LAUNCHES["field_inv"] == 1
    assert cuda.LAUNCHES["ntt_block_stages"] == 1 and cuda.LAUNCHES["ntt_cross_stage"] == 1
