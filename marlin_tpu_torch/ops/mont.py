"""Fr Montgomery product on the row-major `[n, 16]` layout.

Counterpart of `marlin_tpu/ops/pallas/mont.py::mont_mul_pallas`.  On the
card the same function is kernel 1's Fr multiply (csrc/field.cu), so this
is a named entry into it rather than a second kernel; on the CPU it is the
plain CIOS product.
"""

from __future__ import annotations

import torch

from . import fr


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b·R^-1 mod r for [n, 16] Fr Montgomery limbs (canonical output)."""
    if a.shape != b.shape or a.dim() != 2 or a.shape[1] != fr.L:
        raise ValueError(f"mont_mul expects two [n, {fr.L}] tensors")
    return fr.mul(a, b)
