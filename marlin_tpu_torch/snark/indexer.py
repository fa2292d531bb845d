"""AHP indexer: circuit -> Index (reference src/ahp/indexer.rs).

Deterministic preprocessing: synthesize in Setup mode with the Weight goal,
pad the input, square the matrices, compute the joint sparsity pattern, and
arithmetize A*, B*, C* into six LDE polynomials over K (iNTTs on `device`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import host_field as hf
from ..ops.sparse import CooMatrix
from . import ahp
from .constraint_systems import (
    MatrixArithmetization,
    arithmetize_matrix,
    make_matrices_square,
    num_non_zero,
    pad_input_for_indexer_and_prover,
    sum_matrices,
)
from .domains import Radix2Domain, new_domain
from .r1cs import ConstraintSystem, OptimizationGoal, SynthesisMode


from .errors import AHPError


class IndexingError(AHPError):
    """AHP indexing failure (reference ahp/mod.rs:269-287 arms)."""


@dataclass(frozen=True)
class IndexInfo:
    """Reference src/ahp/indexer.rs:31-78."""

    num_variables: int
    num_constraints: int
    num_non_zero: int
    num_instance_variables: int

    def max_degree(self) -> int:
        return ahp.max_degree(self.num_constraints, self.num_variables, self.num_non_zero)

    def to_bytes(self) -> bytes:
        """Transcript encoding: three u64s (reference indexer.rs:63-69)."""
        return (
            hf.u64_to_bytes(self.num_variables)
            + hf.u64_to_bytes(self.num_constraints)
            + hf.u64_to_bytes(self.num_non_zero)
        )


@dataclass
class Index:
    """Reference src/ahp/indexer.rs:114-147."""

    index_info: IndexInfo
    a: CooMatrix
    b: CooMatrix
    c: CooMatrix
    joint_arith: MatrixArithmetization
    domain_h: Radix2Domain
    domain_k: Radix2Domain
    domain_x: Radix2Domain

    def max_degree(self) -> int:
        return self.index_info.max_degree()

    @property
    def device(self) -> torch.device:
        return self.a.vals.device

    def iter_polys(self) -> list:
        """(label, coeffs, degree_bound) in INDEXER_POLYNOMIALS order."""
        return self.joint_arith.labeled_polys()


def index_circuit(circuit, device) -> Index:
    """AHPForR1CS::index (reference src/ahp/indexer.rs:151-234)."""
    cs = ConstraintSystem(mode=SynthesisMode.SETUP, optimization_goal=OptimizationGoal.WEIGHT)
    circuit.generate_constraints(cs)
    pad_input_for_indexer_and_prover(cs)
    cs.finalize()
    make_matrices_square(cs)
    a_rows, b_rows, c_rows = cs.to_matrices()
    joint = sum_matrices(a_rows, b_rows, c_rows)
    nnz = num_non_zero(joint)

    num_formatted_inputs = cs.num_instance_variables
    num_witness = cs.num_witness_variables
    num_constraints = cs.num_constraints
    num_variables = num_formatted_inputs + num_witness

    if num_constraints != num_variables:
        raise IndexingError(
            f"non-square: {num_variables} variables vs {num_constraints} constraints"
        )
    if not ahp.num_formatted_inputs_is_admissible(num_formatted_inputs):
        raise IndexingError(f"formatted input length {num_formatted_inputs} not a power of two")

    info = IndexInfo(
        num_variables=num_variables,
        num_constraints=num_constraints,
        num_non_zero=nnz,
        num_instance_variables=num_formatted_inputs,
    )

    domain_h = new_domain(num_constraints)
    domain_k = new_domain(nnz)
    domain_x = new_domain(num_formatted_inputs)

    joint_arith = arithmetize_matrix(
        joint, a_rows, b_rows, c_rows, domain_k, domain_h, domain_x, device
    )

    # The int64 segment sums (ops/sparse._scatter_sum_mod) are exact up to
    # ~2^47 contributions per segment; the JAX package's byte-plane sums gate
    # total joint nnz at 2^24, and the port keeps that gate so the two accept
    # the same circuits.
    if nnz >= (1 << 24):
        raise IndexingError(
            "joint nnz exceeds the byte-plane segment-sum capacity (2^24)"
        )

    n = num_variables

    def with_reindex(m: CooMatrix) -> CooMatrix:
        from .constraint_systems import _reindex_np

        cols = m.cols.cpu().numpy()
        re = _reindex_np(cols, domain_h, domain_x)
        return CooMatrix(
            rows=m.rows,
            cols=m.cols,
            vals=m.vals,
            num_rows=m.num_rows,
            num_cols=m.num_cols,
            cols_reindexed=torch.as_tensor(re.astype(np.int64), device=device),
        )

    return Index(
        index_info=info,
        a=with_reindex(CooMatrix.from_rows(a_rows, num_constraints, n, device)),
        b=with_reindex(CooMatrix.from_rows(b_rows, num_constraints, n, device)),
        c=with_reindex(CooMatrix.from_rows(c_rows, num_constraints, n, device)),
        joint_arith=joint_arith,
        domain_h=domain_h,
        domain_k=domain_k,
        domain_x=domain_x,
    )
