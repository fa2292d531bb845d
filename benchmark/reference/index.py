"""Marlin's indexer, worked out again in plain Python ints.

From a circuit's R1CS matrices (rows of (coefficient, column), columns of
the instance first, the constant one at column 0) this builds what the
program's index commits to: the joint sparsity pattern of A, B and C, and
on the domain K the evaluations of the six index polynomials (arkworks
marlin src/ahp/constraint_systems.rs; the matrices are read transposed, so
`row` carries the column's element of H and `col` the row's), and then
each polynomial's value at the setup's trapdoor tau by the Lagrange basis of
K, without any interpolation:

    p(tau) = sum_k p(w^k) * L_k(tau),   L_k(tau) = (tau^|K| - 1) w^k / (|K| (tau - w^k)).

A commitment to an index polynomial (no hiding, no degree bound) is
p(tau) * g, so with tau known the commitments are one scalar product each.
"""

from __future__ import annotations

from dataclasses import dataclass

from .curves import Curve

INDEX_LABELS = ("row", "col", "a_val", "b_val", "c_val", "row_col")


@dataclass(frozen=True)
class IndexInfo:
    num_variables: int
    num_constraints: int
    num_non_zero: int
    num_instance: int

    def to_bytes(self) -> bytes:
        return b"".join(v.to_bytes(8, "little")
                        for v in (self.num_variables, self.num_constraints, self.num_non_zero))


def domain_size(curve: Curve, n: int) -> int:
    """The radix-2 domain of at least n points.  The reference has no
    mixed-radix domains: a size past the field's 2-adicity is refused."""
    size = 1 << max(0, (max(1, n) - 1).bit_length())
    if size.bit_length() - 1 > curve.two_adicity:
        raise ValueError(f"domain of {n} points exceeds the 2-adicity of {curve.name}")
    return size


def domain_gen(curve: Curve, size: int) -> int:
    return pow(curve.two_adic_root, 1 << (curve.two_adicity - (size.bit_length() - 1)), curve.r)


def reindex(col: int, h: int, x: int) -> int:
    """Position of the variable in column `col` inside H, with the input's
    domain X embedded at stride |H|/|X| (ark-poly reindex_by_subdomain)."""
    period = h // x
    if period == 1 or col < x:
        return col * period
    i = col - x
    return i + i // (period - 1) + 1


def index_evals(curve: Curve, a: list, b: list, c: list, num_instance: int):
    """-> (IndexInfo, {label: evaluations over K}) of square matrices."""
    r = curve.r
    n = len(a)
    joint = [sorted({j for _, j in ra} | {j for _, j in rb} | {j for _, j in rc})
             for ra, rb, rc in zip(a, b, c)]
    nnz = sum(len(row) for row in joint)
    h = domain_size(curve, n)
    k = domain_size(curve, nnz)
    x = domain_size(curve, num_instance)
    w_h = domain_gen(curve, h)
    pow_h = [1] * h
    for i in range(1, h):
        pow_h[i] = pow_h[i - 1] * w_h % r
    h_inv = pow(h, -1, r)
    mats = [[dict((j, v % r) for v, j in row) for row in m] for m in (a, b, c)]

    ev = {label: [0] * k for label in INDEX_LABELS}
    ev["row"] = [1] * k
    ev["col"] = [1] * k
    ev["row_col"] = [1] * k
    pos = 0
    for i, cols in enumerate(joint):
        for j in cols:
            row_e = pow_h[reindex(j, h, x)]
            col_e = pow_h[i]
            ev["row"][pos] = row_e
            ev["col"][pos] = col_e
            ev["row_col"][pos] = row_e * col_e % r
            scale = row_e * h_inv % r
            for label, m in zip(("a_val", "b_val", "c_val"), mats):
                v = m[i].get(j, 0)
                if v:
                    ev[label][pos] = v * scale % r
            pos += 1
    info = IndexInfo(num_variables=n, num_constraints=n, num_non_zero=nnz, num_instance=num_instance)
    return info, ev


def lagrange_at(curve: Curve, size: int, tau: int) -> list:
    """L_k(tau) for every k of the radix-2 domain of `size` points."""
    r = curve.r
    w = domain_gen(curve, size)
    elems = [1] * size
    for i in range(1, size):
        elems[i] = elems[i - 1] * w % r
    dens = [(tau - e) % r for e in elems]
    if not all(dens):
        raise ValueError("tau lies in the domain")
    # one inversion for all of them (Montgomery's trick)
    pref = [1] * (size + 1)
    for i, d in enumerate(dens):
        pref[i + 1] = pref[i] * d % r
    inv = pow(pref[size], -1, r)
    scale = (pow(tau, size, r) - 1) * pow(size, -1, r) % r
    out = [0] * size
    for i in range(size - 1, -1, -1):
        out[i] = inv * pref[i] % r * elems[i] % r * scale % r
        inv = inv * dens[i] % r
    return out


def values_at(curve: Curve, evals: dict, tau: int) -> dict:
    """{label: p(tau)} of polynomials given by their evaluations over K."""
    r = curve.r
    k = len(next(iter(evals.values())))
    lag = lagrange_at(curve, k, tau)
    return {label: sum(e * l for e, l in zip(vals, lag) if e) % r for label, vals in evals.items()}
