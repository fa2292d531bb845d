"""NTTs over Fr: radix-2 and mixed-radix.

Port of `marlin_tpu/ops/ntt.py`.  Radix-2: decimation-in-time on
bit-reversed input, log2(n) butterfly stages, inverse scaled by n^-1.  The
output matches the JAX package limb for limb; only the staging differs.

On a CUDA tensor the stages run as kernel 3 (csrc/ntt.cu): one launch of
(a) gathers the input in bit-reversed order, scales it by n^-1 for an
inverse transform and runs the first `BLOCK_LOG2` stages in shared memory,
one block per B-element block of the output; then (b) runs the remaining
stages a group a launch (`cross_groups`: every cross stage of a transform
up to 2^17 points at 8 words, 2^16 at 24, in one group).  A transform is
therefore 1 + len(cross_groups(...)) launches and nothing else: no
permuted copy and no separate n^-1 product.
On a CPU tensor the plain twins of those two kernels run
(`block_stages_plain`, `cross_stages_plain`) — the same gather, scale and
stage math in plain PyTorch.

Mixed-radix sizes n = n1·n2 (n1 = base^s, n2 = 2^k; the domains of a
field of low 2-adicity, `snark/domains.py`: n1 = 3^s <= 27 for
synthetic_lowadic and BN254, <= 81 for test_wide750, whose 3-adicity is 4)
take the reference's Cooley-Tukey split (`_ntt_mixed_core`,
marlin_tpu/ops/ntt.py:165): the n1 inner radix-2 transforms of size n2,
with root ω^{n1}, run as ONE batch of kernel 3 over the flattened
[n1·n2, L] array (an inverse transform's n^-1 enters as kernel 3(a)'s
scale); the twiddle by W[j1, k2] is one kernel-1 product; the small DFT
over j1 is one broadcast kernel-1 product of [n1, n1, n2] and one `modsum`
over j1, not n1^2 launches (at n1 = 81 and n2 = 2^9 that product holds
3.4M elements, 0.6 GB of 24-word limbs).  The plain path is the same
sequence through the plain twins.

Under a mesh (parallel/context.py) `ntt` and `intt` route a power-of-two
size of at least `NTT_MIN_SHARDED` whose four-step factors divide over
the mesh to the four-step NTT (parallel/ntt_sharded.py), and
`ntt_many`/`intt_many` then transform one polynomial at a time.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import active as P
from . import bigint as bi
from . import cuda, fr
from .limbs import ints_to_limbs

R = P.R_MODULUS

# in-block stages of kernel 3(a): B = 2^10 Fr elements and B - 1 twiddles
# in shared memory, 64 KB at 8 words and 192 KB at 24 words (one block an
# SM; csrc/ntt.cu).  At 24 words the kernel also takes B = 2^9 (96 KB), one
# more 3(b) launch for a 2^11-point transform: chip_smoke.py's block_plan
# times both on test_wide750's inner transforms (PERF.md §6): 2^10 was
# 10-20% faster at |K|'s 27 transforms and within 2% at |H|'s 9, so both
# widths run the same blocks.
BLOCK_LOG2 = 10
# kernel 3(b)'s shared-memory tile (csrc/ntt.cu kCrossSmem): 2^(s1-s0) rows
# of at least min(8, 2^s0) elements of 4 L bytes
CROSS_SMEM_BYTES = 96 * 1024


def cross_groups(log_n: int, log_b: int, L: int | None = None) -> list:
    """The groups [s0, s1) of consecutive stages past the block that kernel
    3(b) runs a launch each, for 2^log_n-point transforms of [.., L] limbs
    (Fr's by default): the largest group whose tile of 2^(s1-s0) rows of
    min(8, 2^s0) elements fits CROSS_SMEM_BYTES, from s0 = log_b on; every
    stage log_b .. log_n - 1 in exactly one group."""
    L = fr.L if L is None else L
    log_e = (CROSS_SMEM_BYTES // (4 * L)).bit_length() - 1  # the tile's elements, a power of two
    groups, s0 = [], log_b
    while s0 < log_n:
        s1 = min(log_n, s0 + log_e - min(3, s0))
        groups.append((s0, s1))
        s0 = s1
    return groups


@functools.lru_cache(maxsize=None)
def _plan(n: int, inverse: bool, root: int | None = None):
    """(bit-reversal permutation [n], twiddle table [n-1, L] uint32).

    Stage s (half-blocks of m = 2^s) uses rows [m-1, 2m-1) of the table:
    TW_s[j] = w_{2m}^j in Montgomery form, w_{2m} = g^(n/2m) with g the
    generator of Radix2Domain(n) (its inverse for inverse transforms), or
    `root`, a primitive n-th root already inverted for an inverse transform
    (the inner transforms of a mixed-radix size run with ω^{n1}; the
    reference's `_plan` takes the same argument)."""
    from ..snark.domains import Radix2Domain

    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    if root is None:
        dom = Radix2Domain(n)
        g = dom.group_gen_inv if inverse else dom.group_gen
    else:
        g = root
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
def _plan_tensors(n: int, inverse: bool, device: torch.device, root: int | None = None):
    """(twiddle table [n-1, L] int32, n^-1 [L] for an inverse transform
    or None) on `device`.  With a `root` (a mixed-radix size's inner
    transforms) there is no scale: the caller scales by its own n^-1."""
    tw = torch.as_tensor(_plan(n, inverse, root)[1].astype(np.int32), device=device)
    return tw, fr.from_int(pow(n, -1, R), device) if inverse and root is None else None


@functools.lru_cache(maxsize=None)
def _mixed_plan(n: int, inverse: bool):
    """Host precompute of the Cooley-Tukey split n = n1·n2 (n1 = base^s,
    n2 = 2^k; marlin_tpu/ops/ntt.py:108): (n1, n2, the inner root ω^{n1},
    W[j1, k2] = ω^{j1 k2} as [n1, n2, L] limbs, M[k1, j1] = (ω^{n2})^{j1 k1}
    as [n1, n1, L] limbs), ω the domain's generator (inverted for an
    inverse transform), all in Montgomery form."""
    from ..snark.domains import MixedRadixDomain, factor_size

    two, base, exp = factor_size(n)
    n1, n2 = base**exp, 1 << two
    assert n1 > 1, "a mixed plan needs a small-subgroup factor"
    dom = MixedRadixDomain(n)
    w = dom.group_gen_inv if inverse else dom.group_gen

    def powers(g: int, count: int) -> list:
        out, t = [], 1
        for _ in range(count):
            out.append(t * P.FR_MONT_R % R)
            t = t * g % R
        return out

    W = [v for j1 in range(n1) for v in powers(pow(w, j1, R), n2)]
    wn2 = pow(w, n2, R)
    M = [v for k1 in range(n1) for v in powers(pow(wn2, k1, R), n1)]
    return (n1, n2, pow(w, n1, R), ints_to_limbs(W, fr.L).reshape(n1, n2, fr.L),
            ints_to_limbs(M, fr.L).reshape(n1, n1, fr.L))


@functools.lru_cache(maxsize=None)
def _mixed_tensors(n: int, inverse: bool, device: torch.device):
    """`_mixed_plan` on `device`: (n1, n2, inner twiddle table or None,
    W [n1, n2, L], M [n1, n1, 1, L], n^-1 [L] for an inverse transform or
    None)."""
    n1, n2, root, W, M = _mixed_plan(n, inverse)
    tw = _plan_tensors(n2, inverse, device, root)[0] if n2 > 1 else None
    W, M = (torch.as_tensor(a.astype(np.int32), device=device) for a in (W, M))
    scale = fr.from_int(pow(n, -1, R), device) if inverse else None
    return n1, n2, tw, W, M[:, :, None], scale


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
    """Stages 0..log_b-1 of every aligned 2^log_b block of x ([total, L])
    after the bit-reversal of each 2^log_n transform and the product by
    `scale` (if given); a new tensor."""
    n = 1 << log_n
    x = x.reshape(-1, n, fr.L).index_select(1, _rev_tensor(n, x.device)).reshape(-1, fr.L)
    if scale is not None:
        x = bi.mont_mul(fr.CTX, x, scale)
    for s in range(log_b):
        x = _stage_plain(x, tw, s)
    return x


def cross_stages_plain(x: torch.Tensor, tw: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """DIT stages s0 .. s1-1 over all of x ([total, L]); a new tensor."""
    for s in range(s0, s1):
        x = _stage_plain(x, tw, s)
    return x


# --------------------------------------------------------------------------
# kernel wrappers (csrc/ntt.cu): (a) writes a new tensor, (b) updates x in place


def _check_stage_args(x: torch.Tensor, tw: torch.Tensor) -> None:
    cuda.require_cuda_field_tensor(x, "ntt x", fr.L)
    cuda.require_cuda_field_tensor(tw, "ntt twiddles", fr.L)
    if x.dim() != 2 or x.device != tw.device:
        raise ValueError("ntt kernels take [total, L] x and twiddles on one device")


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
    err = cuda.lib().marlin_ntt_block_stages(
        x.data_ptr(), y.data_ptr(), x.shape[0], log_n, log_b, tw.data_ptr(),
        None if scale is None else scale.data_ptr(), bi._params_ptr(fr.CTX), cuda.stream_handle(x),
    )
    cuda.LAUNCHES["ntt_block_stages"] += 1
    cuda.check(err, "ntt_block_stages")
    return y


def cross_stages_kernel(x: torch.Tensor, tw: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """Kernel 3(b): DIT stages s0 .. s1-1 over all of x in one launch, in
    place (a group of `cross_groups`)."""
    _check_stage_args(x, tw)
    err = cuda.lib().marlin_ntt_cross_stages(
        x.data_ptr(), x.shape[0], s0, s1, tw.data_ptr(), bi._params_ptr(fr.CTX), cuda.stream_handle(x),
    )
    cuda.LAUNCHES["ntt_cross_stage"] += 1
    cuda.check(err, "ntt_cross_stage")
    return x


# --------------------------------------------------------------------------
# transforms


def _radix2_stages(flat: torch.Tensor, log_n: int, tw, scale, plain: bool, block_log2: int):
    """Every 2^log_n transform of flat [total, L] (log_n >= 1): kernel 3(a)
    and one 3(b) launch per group of stages past the block, or their plain
    twins."""
    log_b = min(log_n, block_log2)
    if plain:
        y = block_stages_plain(flat, tw, log_b, log_n, scale)
        for s0, s1 in cross_groups(log_n, log_b):
            y = cross_stages_plain(y, tw, s0, s1)
    else:
        y = block_stages_kernel(flat, tw, log_b, log_n, scale)
        for s0, s1 in cross_groups(log_n, log_b):
            cross_stages_kernel(y, tw, s0, s1)
    return y


def _log2(n: int) -> int:
    return n.bit_length() - 1


# mixed-radix transforms run, by the device of their tensor
MIXED_TRANSFORMS = {"cuda": 0, "cpu": 0}


def _mixed(x: torch.Tensor, inverse: bool, plain: bool, block_log2: int) -> torch.Tensor:
    """The Cooley-Tukey split of a mixed-radix size along dim -2: input
    index j = j1 + n1 j2, output k = k1 n2 + k2 (`_ntt_mixed_core`)."""
    n = x.shape[-2]
    n1, n2, tw, W, M, scale = _mixed_tensors(n, inverse, x.device)
    MIXED_TRANSFORMS["cuda" if x.is_cuda else "cpu"] += 1
    mul = (lambda a, b: bi.mont_mul(fr.CTX, a, b)) if plain else fr.mul
    B = x.numel() // (n * fr.L)
    # [B, n2, n1] -> [B, n1, n2]: row (b, j1) holds x[j1 + n1 j2] over j2
    v = x.reshape(B, n2, n1, fr.L).transpose(1, 2).contiguous()
    if n2 > 1:  # the B n1 inner transforms, one batch; n^-1 as their input scale
        v = _radix2_stages(v.reshape(-1, fr.L), _log2(n2), tw, scale, plain, block_log2)
    v = mul(v.reshape(B, n1, n2, fr.L), W)
    # the small DFT: out[b, k1, k2] = Σ_j1 M[k1, j1] v[b, j1, k2], one product
    out = bi.modsum(fr.CTX, mul(v[:, None], M), dim=2, plain=plain)
    if n2 == 1 and scale is not None:
        out = mul(out, scale)
    return out.reshape(x.shape)


def transform(
    x: torch.Tensor, inverse: bool, plain: bool | None = None, block_log2: int = BLOCK_LOG2
) -> torch.Tensor:
    """NTT (or inverse NTT) along dim -2 of [n, L] or [batch, n, L], n a
    power of two or a mixed-radix domain size.

    `plain=None` picks by device: the kernels for a CUDA tensor, their plain
    twins for a CPU tensor.  `plain=True` forces the plain twins on any
    device (how chip_smoke.py holds the kernels against them)."""
    n = x.shape[-2]
    if plain is None:
        plain = not x.is_cuda
    if n & (n - 1):
        return _mixed(x, inverse, plain, block_log2)
    if n == 1:  # no stage, and n^-1 = 1
        return x.clone()
    tw, scale = _plan_tensors(n, inverse, x.device)
    y = _radix2_stages(x.reshape(-1, fr.L), _log2(n), tw, scale, plain, block_log2)
    return y.reshape(x.shape)


def _pad_for(coeffs: torch.Tensor, n: int) -> torch.Tensor:
    ln = coeffs.shape[0]
    if ln > n:
        raise ValueError(f"poly of length {ln} does not fit domain of size {n}")
    if ln < n:
        return torch.nn.functional.pad(coeffs, (0, 0, 0, n - ln))
    return coeffs


def _sharded_or_none(x: torch.Tensor, inverse: bool):
    """The four-step NTT over the mesh (parallel/ntt_sharded.py) of a
    [n, L] vector when a mesh is active, n is a power of two of at least
    `NTT_MIN_SHARDED` and both four-step factors divide over the mesh
    (ntt.py:310); else None."""
    from ..parallel import context as pctx

    ctx = pctx.current()
    n = x.shape[0]
    # shapes only: the same on every rank of a mesh spanning processes
    if ctx is None or x.dim() != 2 or n < pctx.NTT_MIN_SHARDED or n & (n - 1):
        return None
    n1 = 1 << (_log2(n) // 2)
    d = ctx.num_devices
    if n1 % d or (n // n1) % d:
        return None
    from ..parallel.ntt_sharded import ntt_4step_resident

    return ntt_4step_resident(x, ctx.mesh, ctx.axis, inverse=inverse)


def _batchable(n: int, count: int) -> bool:
    """Batch several transforms into one set of launches: a power of two,
    and no mesh that would shard this size (ntt.py:267).  Sizes only, so
    every rank of a mesh spanning processes decides alike."""
    from ..parallel import context as pctx

    return count > 1 and not (n & (n - 1)) and (pctx.current() is None or n < pctx.NTT_MIN_SHARDED)


def ntt(coeffs: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations at [1, g, g^2, ...]; zero-pads
    to `n` (or the smallest domain that fits)."""
    if n is None:
        from ..snark.domains import compute_size_of_domain

        n = compute_size_of_domain(max(1, coeffs.shape[0]))
        if n is None:
            raise ValueError(f"no evaluation domain of size >= {coeffs.shape[0]}")
    x = _pad_for(coeffs, n)
    out = _sharded_or_none(x, False)
    return out if out is not None else transform(x, inverse=False)


def intt(evals: torch.Tensor) -> torch.Tensor:
    """Inverse NTT: evaluations on the size-n domain -> coefficients."""
    out = _sharded_or_none(evals, True)
    return out if out is not None else transform(evals, inverse=True)


def ntt_many(polys: list, n: int) -> list:
    """Forward NTTs of several polynomials onto one size-n domain, batched
    into one set of launches where `_batchable`, else one `ntt` a polynomial
    (a mixed-radix size, or one the mesh shards); either way bit-identical
    to per-poly `ntt`."""
    if not _batchable(n, len(polys)):
        return [ntt(p, n) for p in polys]
    out = transform(torch.stack([_pad_for(p, n) for p in polys]), inverse=False)
    return list(out.unbind(0))


def intt_many(evals: list) -> list:
    """Inverse NTTs of several same-size evaluation vectors, batched where
    `_batchable`, else one at a time."""
    n = evals[0].shape[0]
    assert all(e.shape[0] == n for e in evals)
    if not _batchable(n, len(evals)):
        return [intt(e) for e in evals]
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
    """[n, L] tensor of [1, g, g^2, ...] in Montgomery form (cached)."""
    return _domain_tensor(n, torch.device(device))
