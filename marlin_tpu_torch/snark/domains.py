"""Multiplicative evaluation domains over Fr (radix-2 and mixed-radix).

Host-side mirror of `ark-poly`'s `GeneralEvaluationDomain` — the slice the
reference pins (SURVEY.md §1 row 7): size computation, generator powers,
vanishing-polynomial evaluation, and the protocol-critical
`reindex_by_subdomain` interleaving (reference src/ahp/prover.rs:329-348,
src/ahp/constraint_systems.rs:180).

Domain selection follows ark-poly's GeneralEvaluationDomain::new: radix-2
(size = next power of two) when the field's usable 2-adicity covers it,
otherwise the **mixed-radix** fallback — sizes of the form
``base^s * 2^k`` drawn from the field's small-subgroup structure
(FR_SMALL_SUBGROUP_BASE/ADICITY in the curve config).  BLS12-381's Fr
(2-adicity 32) never leaves the radix-2 branch; BN254's Fr carries a
2^28 * 3^2 subgroup, so its mixed branch is real and tested.  The MNT*-753
configs the reference benches (benches/bench.rs:161-175) would plug into
the same machinery with base 5.

``MARLIN_TPU_FR_TWO_ADICITY_CAP`` (env, test affordance) lowers the usable
2-adicity so the mixed-radix path can be exercised end-to-end at small
sizes, the way a genuinely low-2-adicity field (MNT4-753: 2-adicity 15)
would force it at 2^16.

The heavy per-element work (NTT, batched Lagrange/bivariate evals) lives on
device in ops/ntt.py; these classes hold the scalar metadata those kernels
are parameterized by.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

from ..fields import active as P

R = P.R_MODULUS


def _usable_two_adicity() -> int:
    cap = os.environ.get("MARLIN_TPU_FR_TWO_ADICITY_CAP")
    if cap is not None:
        return min(int(cap), P.FR_TWO_ADICITY)
    return P.FR_TWO_ADICITY


def _radix2_size(num_coeffs: int) -> int | None:
    size = max(1, num_coeffs)
    size = 1 << (size - 1).bit_length()
    if size.bit_length() - 1 > _usable_two_adicity():
        return None
    return size


def _mixed_size(num_coeffs: int) -> int | None:
    """Smallest base^s * 2^k >= num_coeffs within the field's subgroup
    structure (ark-poly MixedRadixEvaluationDomain::compute_size_of_domain)."""
    base = getattr(P, "FR_SMALL_SUBGROUP_BASE", None)
    if not base:
        return None
    best = None
    q_pow = 1
    for _ in range(getattr(P, "FR_SMALL_SUBGROUP_ADICITY", 0) + 1):
        for k in range(_usable_two_adicity() + 1):
            size = q_pow << k
            if size >= num_coeffs and (best is None or size < best):
                best = size
        q_pow *= base
    return best


def compute_size_of_domain(num_coeffs: int) -> int | None:
    """Constructible domain size >= num_coeffs (radix-2 preferred, mixed
    fallback) — GeneralEvaluationDomain::compute_size_of_domain semantics
    (used at reference src/ahp/mod.rs:79-82,100-101)."""
    size = _radix2_size(num_coeffs)
    if size is not None:
        return size
    return _mixed_size(num_coeffs)


def factor_size(size: int) -> tuple[int, int, int]:
    """(two_exp, base, base_exp) with size = 2^two_exp * base^base_exp."""
    two = (size & -size).bit_length() - 1
    odd = size >> two
    base = getattr(P, "FR_SMALL_SUBGROUP_BASE", None) or 1
    exp = 0
    while base > 1 and odd % base == 0:
        odd //= base
        exp += 1
    if odd != 1:
        raise ValueError(f"domain size {size} is not 2^k * {base}^s")
    return two, base, exp


class _DomainBase:
    """Shared scalar machinery; subclasses supply `group_gen`."""

    size: int

    @functools.cached_property
    def group_gen_inv(self) -> int:
        return pow(self.group_gen, -1, R)

    @functools.cached_property
    def size_inv(self) -> int:
        return pow(self.size, -1, R)

    def size_as_field_element(self) -> int:
        return self.size % R

    def element(self, i: int) -> int:
        return pow(self.group_gen, i, R)

    def elements(self) -> list[int]:
        out = [1]
        g = self.group_gen
        for _ in range(self.size - 1):
            out.append(out[-1] * g % R)
        return out

    def evaluate_vanishing_polynomial(self, x: int) -> int:
        """v_D(x) = x^|D| - 1."""
        return (pow(x, self.size, R) - 1) % R

    def eval_unnormalized_bivariate_lagrange_poly(self, x: int, y: int) -> int:
        """u_D(x, y) = (v_D(x) - v_D(y)) / (x - y); diagonal |D| * x^(|D|-1).

        Reference: src/ahp/mod.rs:302-309.
        """
        if x != y:
            num = (self.evaluate_vanishing_polynomial(x) - self.evaluate_vanishing_polynomial(y)) % R
            return num * pow((x - y) % R, -1, R) % R
        return self.size * pow(x, self.size - 1, R) % R

    def evaluate_all_lagrange_coefficients(self, tau: int) -> list[int]:
        """L_i(tau) for all i — used by the succinct verifier on domain X only
        (reference src/ahp/mod.rs:154-159), so a host loop is fine.
        """
        n = self.size
        v = self.evaluate_vanishing_polynomial(tau)
        if v == 0:
            # tau inside the domain: indicator vector
            out = [0] * n
            g = 1
            for i in range(n):
                if g == tau % R:
                    out[i] = 1
                g = g * self.group_gen % R
            return out
        # L_i(tau) = (g^i * v) / (n * (tau - g^i))
        out = []
        g_i = 1
        v_over_n = v * self.size_inv % R
        for _ in range(n):
            out.append(v_over_n * g_i % R * pow((tau - g_i) % R, -1, R) % R)
            g_i = g_i * self.group_gen % R
        return out

    def reindex_by_subdomain(self, other: "_DomainBase", index: int) -> int:
        """Position of `other`'s element `index` inside `self`'s ordering.

        `other` (size m) embeds in `self` (size n) at stride n/m; remaining
        indices are renumbered around those slots.  This interleaving is
        protocol-critical for the w/x packing — reference
        src/ahp/prover.rs:340-348 and ark-poly's reindex_by_subdomain.
        """
        assert self.size >= other.size and self.size % other.size == 0
        period = self.size // other.size
        if index < other.size:
            return index * period
        i = index - other.size
        return i + i // (period - 1) + 1

    def sample_element_outside_domain(self, rand_fr) -> int:
        """rand_fr: callable returning a random Fr int (the FS rng)."""
        t = rand_fr()
        while self.evaluate_vanishing_polynomial(t) == 0:
            t = rand_fr()
        return t


@dataclass(frozen=True)
class Radix2Domain(_DomainBase):
    """Multiplicative subgroup of Fr of power-of-two order."""

    size: int

    @staticmethod
    def new(num_coeffs: int) -> "Radix2Domain":
        size = _radix2_size(num_coeffs)
        if size is None:
            raise ValueError(f"radix-2 domain of size {num_coeffs} not constructible")
        return Radix2Domain(size)

    @property
    def log_size(self) -> int:
        return self.size.bit_length() - 1

    @functools.cached_property
    def group_gen(self) -> int:
        # TWO_ADIC_ROOT ^ (2^(adicity - log_size)); same element arkworks uses.
        return pow(P.FR_TWO_ADIC_ROOT_OF_UNITY, 1 << (P.FR_TWO_ADICITY - self.log_size), R)


@dataclass(frozen=True)
class MixedRadixDomain(_DomainBase):
    """Subgroup of order base^s * 2^k (ark-poly MixedRadixEvaluationDomain)."""

    size: int

    @staticmethod
    def new(num_coeffs: int) -> "MixedRadixDomain":
        size = _mixed_size(num_coeffs)
        if size is None:
            raise ValueError(f"mixed-radix domain of size {num_coeffs} not constructible")
        return MixedRadixDomain(size)

    @functools.cached_property
    def group_gen(self) -> int:
        two, base, exp = factor_size(self.size)
        if exp == 0:
            return Radix2Domain(self.size).group_gen
        full_order = (1 << P.FR_TWO_ADICITY) * base**P.FR_SMALL_SUBGROUP_ADICITY
        g = pow(P.FR_LARGE_SUBGROUP_ROOT_OF_UNITY, full_order // self.size, R)
        assert pow(g, self.size, R) == 1 and pow(g, self.size // 2, R) != 1
        return g


def new_domain(num_coeffs: int) -> _DomainBase:
    """GeneralEvaluationDomain::new: radix-2 if representable, else mixed."""
    if _radix2_size(num_coeffs) is not None:
        return Radix2Domain.new(num_coeffs)
    return MixedRadixDomain.new(num_coeffs)


def domain_of_size(size: int) -> _DomainBase:
    """Reconstruct a domain object from an exact (already-valid) size."""
    if size & (size - 1) == 0 and size.bit_length() - 1 <= P.FR_TWO_ADICITY:
        return Radix2Domain(size)
    return MixedRadixDomain(size)
