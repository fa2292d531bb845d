"""Radix-2 NTT over Fr.

Port of `marlin_tpu/ops/ntt.py` (radix-2 path): decimation-in-time on
bit-reversed input, log2(n) butterfly stages, inverse scaled by n^-1.  The
output matches the JAX package limb for limb; only the staging differs.

On a CUDA tensor the stages run as kernel 3 (csrc/ntt.cu): one launch of
(a) gathers the input in bit-reversed order, scales it by n^-1 for an
inverse transform and runs the first `BLOCK_LOG2` stages in shared memory,
one block per B-element block of the output; then (b) runs one global
launch per remaining stage.  A transform is therefore 1 + max(0, log2(n) -
10) launches and nothing else: no permuted copy and no separate n^-1
product.
On a CPU tensor the plain twins of those two kernels run
(`block_stages_plain`, `cross_stage_plain`) — the same gather, scale and
stage math in plain PyTorch.  Mixed-radix domains are not ported yet.
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

# in-block stages of kernel 3(a): B = 2^10 Fr elements and B - 1 twiddles,
# 64 KB of shared memory
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
    """(twiddle table [n-1, 16] int32, n^-1 [16] for an inverse transform
    or None) on `device`."""
    tw = torch.as_tensor(_plan(n, inverse)[1].astype(np.int32), device=device)
    return tw, fr.from_int(pow(n, -1, R), device) if inverse else None


@functools.lru_cache(maxsize=None)
def _rev_tensor(n: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_plan(n, False)[0], device=device)


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


def block_stages_plain(
    x: torch.Tensor, tw: torch.Tensor, log_b: int, log_n: int, scale: torch.Tensor | None = None
) -> torch.Tensor:
    """Stages 0..log_b-1 of every aligned 2^log_b block of x ([total, 16])
    after the bit-reversal of each 2^log_n transform and the product by
    `scale` (if given); a new tensor."""
    n = 1 << log_n
    x = x.reshape(-1, n, fr.L).index_select(1, _rev_tensor(n, x.device)).reshape(-1, fr.L)
    if scale is not None:
        x = bi.mont_mul(fr.CTX, x, scale)
    for s in range(log_b):
        x = _stage_plain(x, tw, s)
    return x


def cross_stage_plain(x: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """DIT stage s over all of x ([total, 16])."""
    return _stage_plain(x, tw, s)


# --------------------------------------------------------------------------
# kernel wrappers (csrc/ntt.cu): (a) writes a new tensor, (b) updates x in place


def _check_stage_args(x: torch.Tensor, tw: torch.Tensor) -> None:
    cuda.require_cuda_field_tensor(x, "ntt x", fr.L)
    cuda.require_cuda_field_tensor(tw, "ntt twiddles", fr.L)
    if x.dim() != 2 or x.device != tw.device:
        raise ValueError("ntt kernels take [total, 16] x and twiddles on one device")


def block_stages_kernel(
    x: torch.Tensor, tw: torch.Tensor, log_b: int, log_n: int, scale: torch.Tensor | None = None
) -> torch.Tensor:
    """Kernel 3(a): `block_stages_plain` (log_b <= 10) in one launch, into
    a new tensor."""
    x = bi._kernel_operand(x, x.shape[:-1])
    _check_stage_args(x, tw)
    if scale is not None:
        cuda.require_cuda_field_tensor(scale, "ntt scale", fr.L)
    y = torch.empty_like(x)
    params = fr.CTX.kernel_params
    err = cuda.lib().marlin_ntt_block_stages(
        x.data_ptr(), y.data_ptr(), x.shape[0], log_n, log_b, tw.data_ptr(),
        None if scale is None else scale.data_ptr(),
        params.ctypes.data_as(ctypes.c_void_p), cuda.stream_handle(x),
    )
    cuda.LAUNCHES["ntt_block_stages"] += 1
    cuda.check(err, "ntt_block_stages")
    return y


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
    if n == 1:  # no stage, and n^-1 = 1
        return x.clone()
    log_n = n.bit_length() - 1
    tw, scale = _plan_tensors(n, inverse, x.device)
    flat = x.reshape(-1, fr.L)
    log_b = min(log_n, block_log2)
    if plain:
        y = block_stages_plain(flat, tw, log_b, log_n, scale)
        for s in range(log_b, log_n):
            y = cross_stage_plain(y, tw, s)
    else:
        y = block_stages_kernel(flat, tw, log_b, log_n, scale)
        for s in range(log_b, log_n):
            cross_stage_kernel(y, tw, s)
    return y.reshape(x.shape)


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
