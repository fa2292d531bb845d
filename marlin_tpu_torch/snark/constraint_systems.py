"""Matrix arithmetization and constraint-system padding.

Rebuild of reference src/ahp/constraint_systems.rs: the R1CS→polynomial
encoding of the joint matrix M* (the Fractal [COS20] optimization
M*(i,j) = M(j,i) · u_H(j,j) — reference comment at
constraint_systems.rs:102-103), plus the padding invariants (square
matrices, power-of-two formatted input).

The per-nonzero loops become numpy index arithmetic + tensor gathers; the
six interpolations are iNTTs on K (kernel 3 on the card).  One algebraic shortcut replaces
the reference's u_H batch-inversion (constraint_systems.rs:162-205):
u_H(h,h)^-1 = h / |H| for h ∈ H, so the val scaling factor is just
row_on_K · |H|^-1 — no inversions at all.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import active as P
from ..ops import fr, ntt
from .domains import Radix2Domain, new_domain
from .r1cs import ConstraintSystem, lc

R = P.R_MODULUS


def num_non_zero(joint_rows: list) -> int:
    return sum(len(r) for r in joint_rows)


def padded_matrix_dim(num_formatted_variables: int, num_constraints: int) -> int:
    """Always in sync with make_matrices_square (reference :41-43)."""
    return max(num_formatted_variables, num_constraints)


def pad_input_for_indexer_and_prover(cs: ConstraintSystem) -> None:
    """Grow the formatted input to the next power of two with zero inputs
    (reference :45-58)."""
    formatted = cs.num_instance_variables
    padded = new_domain(formatted).size
    for _ in range(padded - formatted):
        cs.new_input_variable((lambda: 0) if not cs.is_setup else None)


def make_matrices_square(cs: ConstraintSystem) -> None:
    """Add 0*0=0 constraints or dummy one-valued witnesses (reference :60-81)."""
    num_vars = cs.num_instance_variables + cs.num_witness_variables
    num_constraints = cs.num_constraints
    if num_vars > num_constraints:
        # 0 * 0 == 0 rows; the empty LCs need no expansion post-finalize
        for _ in range(num_vars - num_constraints):
            cs.enforce_constraint(lc(), lc(), lc())
    else:
        for _ in range(num_constraints - num_vars):
            cs.new_witness_variable((lambda: 1) if not cs.is_setup else None)
    assert cs.num_instance_variables + cs.num_witness_variables == cs.num_constraints, (
        "padding failed"
    )


def format_public_input(public_input: list) -> list:
    """Prepend the constant one (reference :270-274)."""
    return [1] + [x % R for x in public_input]


def unformat_public_input(formatted: list) -> list:
    return list(formatted[1:])


def sum_matrices(a: list, b: list, c: list):
    """Per-row sorted union of nonzero columns (reference indexer.rs:83-102)."""
    joint = []
    for ra, rb, rc in zip(a, b, c):
        cols = sorted({i for _, i in ra} | {i for _, i in rb} | {i for _, i in rc})
        joint.append(cols)
    return joint


@dataclass
class MatrixEvals:
    """Evaluations on K of the six index polynomials (reference :87-100)."""

    row: torch.Tensor
    col: torch.Tensor
    row_col: torch.Tensor
    val_a: torch.Tensor
    val_b: torch.Tensor
    val_c: torch.Tensor


@dataclass
class MatrixArithmetization:
    """Coefficient-form index polynomials + their evals on K (reference :104-123).

    Labels follow INDEXER_POLYNOMIALS order: row, col, a_val, b_val, c_val,
    row_col (reference src/ahp/mod.rs:33-36).
    """

    row: torch.Tensor
    col: torch.Tensor
    val_a: torch.Tensor
    val_b: torch.Tensor
    val_c: torch.Tensor
    row_col: torch.Tensor
    evals_on_K: MatrixEvals

    def labeled_polys(self) -> list:
        return [
            ("row", self.row, None),
            ("col", self.col, None),
            ("a_val", self.val_a, None),
            ("b_val", self.val_b, None),
            ("c_val", self.val_c, None),
            ("row_col", self.row_col, None),
        ]


def _reindex_np(idx: np.ndarray, big: Radix2Domain, small: Radix2Domain) -> np.ndarray:
    """Vectorized Radix2Domain.reindex_by_subdomain."""
    period = big.size // small.size
    if period == 1:
        return idx
    i = idx - small.size
    return np.where(idx < small.size, idx * period, i + i // (period - 1) + 1)


def _coo_lookup(mat: list, keys_r: np.ndarray, keys_c: np.ndarray, num_cols: int) -> list:
    """Values of sparse `mat` at positions (keys_r, keys_c); 0 where absent.

    Vectorized with sorted-key binary search — the per-entry dict version
    dominated index wall time at 2^16+ (SURVEY.md §3.2's O(|K|) loop).
    """
    mat_keys = []
    mat_vals = []
    for r, row in enumerate(mat):
        for coeff, i in row:
            mat_keys.append(r * num_cols + i)
            mat_vals.append(coeff)
    if not mat_keys:
        return [0] * len(keys_r)
    mk = np.asarray(mat_keys, dtype=np.int64)
    order = np.argsort(mk, kind="stable")
    mk = mk[order]
    query = keys_r.astype(np.int64) * num_cols + keys_c.astype(np.int64)
    pos = np.searchsorted(mk, query)
    pos_c = np.minimum(pos, len(mk) - 1)
    hit = mk[pos_c] == query
    out = [0] * len(query)
    for j in np.nonzero(hit)[0]:
        out[j] = mat_vals[order[pos_c[j]]]
    return out


def arithmetize_matrix(
    joint_rows: list,
    a: list,
    b: list,
    c: list,
    domain_k: Radix2Domain,
    domain_h: Radix2Domain,
    domain_x: Radix2Domain,
    device,
) -> MatrixArithmetization:
    """Joint arithmetization of A*, B*, C* (reference :125-262).

    Note the transpose: the `row` polynomial carries column elements and
    vice versa (reference :177-193, "We are dealing with the transpose of M").
    """
    # flatten the joint sparsity pattern
    rr, cc = [], []
    for r, cols in enumerate(joint_rows):
        rr.extend([r] * len(cols))
        cc.extend(cols)
    nnz = len(rr)
    k = domain_k.size
    assert nnz <= k
    rows_np = np.asarray(rr + [0] * (k - nnz), dtype=np.int64)
    cols_np = np.asarray(cc + [0] * (k - nnz), dtype=np.int64)
    live = np.arange(k) < nnz

    reindexed = _reindex_np(cols_np, domain_h, domain_x)

    elems = ntt.domain_elements(domain_h.size, device)  # [|H|, 16]
    # transpose land: row poly gets the (reindexed) column element, col poly
    # gets the row element.  Padding entries use elems[0] = 1 (reference :208-214).
    row_on_K = elems[torch.as_tensor(np.where(live, reindexed, 0), device=device)]
    col_on_K = elems[torch.as_tensor(np.where(live, rows_np, 0), device=device)]

    vals_abc = []
    h_inv = fr.from_int(pow(domain_h.size, -1, R), device)
    for mat in (a, b, c):
        v = _coo_lookup(mat, rows_np[:nnz], cols_np[:nnz], domain_h.size)
        ints = [int(x) % R for x in v] + [0] * (k - nnz)
        vdev = fr.from_ints(ints, device)
        # scale by u_H(col_elem, col_elem)^{-1} = row_on_K * |H|^{-1}
        scaled = fr.mul(fr.mul(vdev, row_on_K), h_inv[None, :])
        vals_abc.append(scaled)

    row_col_on_K = fr.mul(row_on_K, col_on_K)

    evals = MatrixEvals(
        row=row_on_K,
        col=col_on_K,
        row_col=row_col_on_K,
        val_a=vals_abc[0],
        val_b=vals_abc[1],
        val_c=vals_abc[2],
    )
    return MatrixArithmetization(
        row=ntt.intt(row_on_K),
        col=ntt.intt(col_on_K),
        val_a=ntt.intt(vals_abc[0]),
        val_b=ntt.intt(vals_abc[1]),
        val_c=ntt.intt(vals_abc[2]),
        row_col=ntt.intt(row_col_on_K),
        evals_on_K=evals,
    )
