"""Sparse matrix ops over Fr tensors.

Port of `marlin_tpu/ops/sparse.py`: the SpMV for z_A / z_B and the
`calculate_t` scatter as a gather, one field product and a per-segment
modular sum.  The segment sum adds the 16-bit limbs in int64 with
`index_add_` — exact up to ~2^47 contributions per segment, where the JAX
package needs its byte-plane split to pass 2^16 — and reduces once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import active as P
from . import fr
from .limbs import ints_to_limbs


@dataclass(frozen=True)
class CooMatrix:
    """Static COO sparse matrix over Fr."""

    rows: torch.Tensor  # [nnz] int64
    cols: torch.Tensor  # [nnz] int64 (variable indices)
    vals: torch.Tensor  # [nnz, 16] Montgomery limbs
    num_rows: int
    num_cols: int
    # column indices remapped into domain-H positions (set by the indexer)
    cols_reindexed: torch.Tensor | None = None

    @staticmethod
    def from_rows(rows_of_terms: list, num_rows: int, num_cols: int, device) -> "CooMatrix":
        """rows_of_terms: list (per row) of (coeff:int, col:int)."""
        r_idx, c_idx, v = [], [], []
        for r, row in enumerate(rows_of_terms):
            for coeff, col in row:
                r_idx.append(r)
                c_idx.append(col)
                v.append(coeff * P.FR_MONT_R % P.R_MODULUS)
        if not r_idx:  # fully-zero matrix: keep one dummy zero entry
            r_idx, c_idx, v = [0], [0], [0]
        return CooMatrix(
            rows=torch.as_tensor(np.asarray(r_idx, dtype=np.int64), device=device),
            cols=torch.as_tensor(np.asarray(c_idx, dtype=np.int64), device=device),
            vals=torch.as_tensor(
                ints_to_limbs(v, fr.L).reshape(len(v), fr.L).astype(np.int32), device=device
            ),
            num_rows=num_rows,
            num_cols=num_cols,
        )

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]


def _scatter_sum_mod(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int):
    """Per-segment modular sum of [nnz, 16] limb vectors -> [num_segments, 16]."""
    acc = torch.zeros((num_segments, fr.L), dtype=torch.int64, device=values.device)
    acc.index_add_(0, seg_ids, values.to(torch.int64))
    return fr.reduce_wide(acc)


def spmv(m: CooMatrix, z: torch.Tensor, out_len: int | None = None) -> torch.Tensor:
    """M @ z -> [out_len, 16] (out_len defaults to num_rows)."""
    out_len = out_len or m.num_rows
    prods = fr.mul(m.vals, z[m.cols])
    return _scatter_sum_mod(prods, m.rows, out_len)


def scatter_add_mod(values: torch.Tensor, indices: torch.Tensor, out_len: int) -> torch.Tensor:
    """out[indices[k]] += values[k] over Fr; the `calculate_t` primitive."""
    return _scatter_sum_mod(values, indices, out_len)
