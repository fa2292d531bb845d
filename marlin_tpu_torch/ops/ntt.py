"""Radix-2 NTT over Fr.

Port of `marlin_tpu/ops/ntt.py` (radix-2 path): decimation-in-time on
bit-reversed input, log2(n) butterfly stages, inverse scaled by n^-1.  The
output matches the JAX package limb for limb; only the staging differs.

On a CUDA tensor the stages run as kernel 3 (csrc/ntt.cu): the first
`BLOCK_LOG2` stages in one shared-memory launch per B-element block, then
one global launch per remaining stage; the n^-1 scaling goes through
kernel 1.  On a CPU tensor the plain twins of those two kernels run
(`block_stages_plain`, `cross_stage_plain`) — the same stage math in plain
PyTorch.  Mixed-radix domains are not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..fields import active as P
from . import bigint as bi
from . import cuda, fr
from .limbs import ints_to_limbs

R = P.R_MODULUS

# in-block stages of kernel 3(a): B = 2^10 Fr elements = 32 KB of shared memory
BLOCK_LOG2 = 10


@functools.lru_cache(maxsize=None)
def _plan(n: int, inverse: bool):
    """(bit-reversal permutation [n], twiddle table [n-1, 16] uint32).

    Stage s (half-blocks of m = 2^s) uses rows [m-1, 2m-1) of the table:
    TW_s[j] = w_{2m}^j in Montgomery form, w_{2m} = g^(n/2m) with g the
    generator of Radix2Domain(n) (its inverse for inverse transforms)."""
    from ..snark.domains import Radix2Domain

    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    dom = Radix2Domain(n)
    g = dom.group_gen_inv if inverse else dom.group_gen
    table = []
    for s in range(log_n):
        m = 1 << s
        w = pow(g, n // (2 * m), R)
        t = 1
        for _ in range(m):
            table.append(t * P.FR_MONT_R % R)
            t = t * w % R
    tw = ints_to_limbs(table, fr.L).reshape(len(table), fr.L)
    return rev, tw


@functools.lru_cache(maxsize=None)
def _plan_tensors(n: int, inverse: bool, device: torch.device):
    rev, tw = _plan(n, inverse)
    tw_t = torch.as_tensor(tw.astype(np.int32), device=device)
    if tw_t.shape[0] == 0:  # n = 1: keep a valid pointer for the kernels
        tw_t = torch.zeros((1, fr.L), dtype=torch.int32, device=device)
    return torch.as_tensor(rev, device=device), tw_t


# --------------------------------------------------------------------------
# plain twins of the two stage kernels


def _stage_plain(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    m = 1 << s
    total = x.shape[0]
    v = x.reshape(total // (2 * m), 2, m, fr.L)
    e, o = v[:, 0], v[:, 1]
    t = bi.mont_mul(fr.CTX, o, tw[m - 1 : 2 * m - 1][None])
    out = torch.stack([bi.add_mod(fr.CTX, e, t), bi.sub_mod(fr.CTX, e, t)], dim=1)
    return out.reshape(total, fr.L)


def block_stages_plain(x: torch.Tensor, tw: torch.Tensor, log_b: int) -> torch.Tensor:
    """Stages 0..log_b-1 of every aligned 2^log_b block of x ([total, 16])."""
    for s in range(log_b):
        x = _stage_plain(x, tw, s)
    return x


def cross_stage_plain(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """DIT stage s over all of x ([total, 16])."""
    return _stage_plain(x, tw, s)


# --------------------------------------------------------------------------
# kernel wrappers (csrc/ntt.cu); both update x in place


def _check_stage_args(x: torch.Tensor, tw: torch.Tensor) -> None:
    cuda.require_cuda_field_tensor(x, "ntt x", fr.L)
    cuda.require_cuda_field_tensor(tw, "ntt twiddles", fr.L)
    if x.dim() != 2 or x.device != tw.device:
        raise ValueError("ntt kernels take [total, 16] x and twiddles on one device")


def block_stages_kernel(x: torch.Tensor, tw: torch.Tensor, log_b: int) -> torch.Tensor:
    """Kernel 3(a): stages 0..log_b-1 (log_b <= 10) of every aligned
    2^log_b block of x, in place."""
    _check_stage_args(x, tw)
    params = fr.CTX.kernel_params
    err = cuda.lib().marlin_ntt_block_stages(
        x.data_ptr(), x.shape[0], log_b, tw.data_ptr(),
        params.ctypes.data_as(ctypes.c_void_p), cuda.stream_handle(x),
    )
    cuda.LAUNCHES["ntt_block_stages"] += 1
    cuda.check(err, "ntt_block_stages")
    return x


def cross_stage_kernel(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """Kernel 3(b): DIT stage s over all of x, in place."""
    _check_stage_args(x, tw)
    params = fr.CTX.kernel_params
    err = cuda.lib().marlin_ntt_cross_stage(
        x.data_ptr(), x.shape[0], s, tw.data_ptr(),
        params.ctypes.data_as(ctypes.c_void_p), cuda.stream_handle(x),
    )
    cuda.LAUNCHES["ntt_cross_stage"] += 1
    cuda.check(err, "ntt_cross_stage")
    return x


# --------------------------------------------------------------------------
# transforms


def transform(
    x: torch.Tensor, inverse: bool, plain: bool | None = None, block_log2: int = BLOCK_LOG2
) -> torch.Tensor:
    """NTT (or inverse NTT) along dim -2 of [n, 16] or [batch, n, 16].

    `plain=None` picks by device: the kernels for a CUDA tensor, their plain
    twins for a CPU tensor.  `plain=True` forces the plain twins on any
    device (how chip_smoke.py holds the kernels against them)."""
    n = x.shape[-2]
    if n & (n - 1):
        raise NotImplementedError(f"mixed-radix NTT (size {n}) is not yet ported")
    if plain is None:
        plain = not x.is_cuda
    log_n = n.bit_length() - 1
    rev, tw = _plan_tensors(n, inverse, x.device)
    batch_shape = x.shape[:-2]
    y = x.index_select(-2, rev).reshape(-1, fr.L).contiguous()
    log_b = min(log_n, block_log2)
    if plain:
        y = block_stages_plain(y, tw, log_b)
        for s in range(log_b, log_n):
            y = cross_stage_plain(y, tw, s)
    else:
        if log_b > 0:
            block_stages_kernel(y, tw, log_b)
        for s in range(log_b, log_n):
            cross_stage_kernel(y, tw, s)
    y = y.reshape(*batch_shape, n, fr.L)
    if inverse:
        n_inv = fr.from_int(pow(n, -1, R), x.device)
        y = bi.mont_mul(fr.CTX, y, n_inv) if plain else bi.binop_kernel("mul", fr.CTX, y, n_inv)
    return y


def _pad_for(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    ln = coeffs.shape[0]
    if ln > n:
        raise ValueError(f"poly of length {ln} does not fit domain of size {n}")
    if ln < n:
        return torch.nn.functional.pad(coeffs, (0, 0, 0, n - ln))
    return coeffs


def ntt(coeffs: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations at [1, g, g^2, ...]; zero-pads
    to `n` (or the smallest domain that fits)."""
    if n is None:
        from ..snark.domains import compute_size_of_domain

        n = compute_size_of_domain(max(1, coeffs.shape[0]))
        if n is None:
            raise ValueError(f"no evaluation domain of size >= {coeffs.shape[0]}")
    return transform(_pad_for(coeffs, n), inverse=False)


def intt(evals: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: evaluations on the size-n domain -> coefficients."""
    return transform(evals, inverse=True)


def ntt_many(polys: list, n: int) -> list:
    """Forward NTTs of several polynomials onto one size-n domain, batched
    into one set of launches; bit-identical to per-poly `ntt`."""
    out = transform(torch.stack([_pad_for(p, n) for p in polys]), inverse=False)
    return list(out.unbind(0))


def intt_many(evals: list) -> list:
    """Inverse NTTs of several same-size evaluation vectors, batched."""
    n = evals[0].shape[0]
    assert all(e.shape[0] == n for e in evals)
    return list(transform(torch.stack(evals), inverse=True).unbind(0))


@functools.lru_cache(maxsize=None)
def _domain_limbs(n: int) -> np.ndarray:
    from ..snark.domains import domain_of_size

    elems = domain_of_size(n).elements()
    return ints_to_limbs([e * P.FR_MONT_R % R for e in elems], fr.L).reshape(n, fr.L)


@functools.lru_cache(maxsize=None)
def _domain_tensor(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_domain_limbs(n).astype(np.int32), device=device)


def domain_elements(n: int, device) -> torch.Tensor:
    """[n, 16] tensor of [1, g, g^2, ...] in Montgomery form (cached)."""
    return _domain_tensor(n, torch.device(device))
