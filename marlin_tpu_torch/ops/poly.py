"""Dense polynomial ops over Fr tensors.

Port of `marlin_tpu/ops/poly.py`: `[len, 16]` Montgomery coefficient
tensors.  Field products, sums and inversions go through ops/fr.py (the
kernels on the card); the block and suffix sums that the JAX package forms
with log-depth trees of field adds are exact int64 prefix sums over the
limbs here, followed by one modular reduction — the same canonical values.
"""

from __future__ import annotations

import torch

from ..fields import active as P
from . import fr, ntt

R = P.R_MODULUS


def pad_to(p: torch.Tensor, length: int) -> torch.Tensor:
    if p.shape[0] < length:
        return torch.nn.functional.pad(p, (0, 0, 0, length - p.shape[0]))
    return p


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = max(a.shape[0], b.shape[0])
    return fr.add(pad_to(a, n), pad_to(b, n))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = max(a.shape[0], b.shape[0])
    return fr.sub(pad_to(a, n), pad_to(b, n))


def scale(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """p * c for a scalar field element c ([16] limbs)."""
    return fr.mul(p, c[None, :])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Polynomial product via NTT."""
    out_len = a.shape[0] + b.shape[0] - 1
    from ..snark.domains import compute_size_of_domain

    n = compute_size_of_domain(max(1, out_len))
    if n is None:
        raise ValueError(f"no evaluation domain of size >= {out_len} is constructible")
    ea, eb = ntt.ntt_many([a, b], n)
    return ntt.intt(fr.mul(ea, eb))[:out_len]


def mul_by_vanishing(p: torch.Tensor, domain_size: int) -> torch.Tensor:
    """p(x) * (x^n - 1)."""
    lp = p.shape[0]
    out = torch.zeros((lp + domain_size, fr.L), dtype=p.dtype, device=p.device)
    out[domain_size:] = p
    return fr.sub(out, pad_to(p, lp + domain_size))


def _suffix_sums(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inclusive reversed prefix sums over Fr along `dim` (exact int64 limb
    sums, one reduction).  The scan runs over the innermost axis: torch's
    scan along an outer axis of a [n, 16] tensor has only 16 columns of
    parallelism on the card."""
    s = x.to(torch.int64).movedim(dim, -1).flip(-1).cumsum(-1).flip(-1)
    return fr.reduce_wide(s.movedim(-1, dim).contiguous())


def divide_by_vanishing(p: torch.Tensor, domain_size: int):
    """(quotient, remainder) of p / (x^n - 1).

    Since x^(kn) ≡ 1 (mod x^n - 1): split p into degree-<n blocks B_i;
    remainder = Σ B_i, quotient block i = Σ_{j>i} B_j."""
    n = domain_size
    lp = p.shape[0]
    if lp <= n:
        return fr.zeros((1,), p.device), pad_to(p, n)[:n]
    nb = -(-lp // n)
    blocks = pad_to(p, nb * n).reshape(nb, n, fr.L)
    suffix = _suffix_sums(blocks, 0)
    remainder = suffix[0][:n]
    quotient = suffix[1:].reshape((nb - 1) * n, fr.L)[: lp - n]
    return quotient, remainder


def powers(z: torch.Tensor, n: int) -> torch.Tensor:
    """[n, 16] tensor of [1, z, z^2, ...] via log-depth bit recombination."""
    k = max(1, (n - 1).bit_length())
    out = fr.ones((n,), z.device)
    idx = torch.arange(n, device=z.device)
    z2j = z
    for j in range(k):
        bit = ((idx >> j) & 1) == 1
        out = fr.select(bit, fr.mul(out, z2j[None, :]), out)
        z2j = fr.sqr(z2j)
    return out


def evaluate(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """p(z) -> [16] limbs (z: [16] limbs)."""
    return evaluate_batch(p[None], z)[0]


def evaluate_many(p: torch.Tensor, zs: list) -> list:
    return [evaluate(p, z) for z in zs]


def evaluate_batch(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Evaluate a stack of (padded) polynomials at one point.

    coeffs: [m, len, 16]; z: [16] -> [m, 16]."""
    pw = powers(z, coeffs.shape[1])
    prods = fr.mul(coeffs, pw[None, :, :])
    return fr.modsum(prods, dim=1)


def div_by_linear(p: torch.Tensor, z: torch.Tensor, zinv: torch.Tensor | None = None):
    """(p(x) - p(z)) / (x - z) -> [len-1, 16]; the KZG witness polynomial.

    Closed form: with u_i = p_i z^i and S_j = Σ_{i>j} u_i, the quotient is
    w_j = S_j z^{-(j+1)}.  Requires z != 0.  Callers dividing several
    polynomials by one point may pass z^-1 ([1, 16]) to invert only once."""
    n = p.shape[0]
    u = fr.mul(p, powers(z, n))
    s = _suffix_sums(u, 0)
    s_shift = torch.cat([s[1:], fr.zeros((1,), p.device)], dim=0)  # Σ_{i>j}
    if zinv is None:
        zinv = fr.inv(z[None, :])
    zinv_pows = powers(zinv[0], n)
    w = fr.mul(fr.mul(s_shift, zinv_pows), zinv)
    return w[: n - 1]


def degree(p: torch.Tensor) -> int:
    """Actual degree, -1 for the zero polynomial (a host read; for asserts
    and tests)."""
    nz = (p != 0).any(-1).nonzero()
    return int(nz[-1]) if nz.numel() else -1
