"""Device routing for the field kernels.

Twin of `marlin_tpu/ops/pallas/routing.py`.  The decision is the tensor's
device and nothing else: a CUDA tensor goes to the hand-written kernel
(csrc/field.cu) and a CPU tensor to the plain PyTorch version in
ops/bigint.py.  There is no environment switch and no fallback: a kernel
that fails to build or launch raises.
"""

from __future__ import annotations

import torch

from . import bigint as bi


def use_cuda(t: torch.Tensor) -> bool:
    return t.is_cuda


def binop(kind: str, ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device != b.device:
        raise ValueError(f"field {kind}: operands on {a.device} and {b.device}")
    if use_cuda(a):
        return bi.binop_kernel(kind, ctx, a, b)
    return bi.PLAIN_OPS[kind](ctx, a, b)


def inv(ctx, x: torch.Tensor) -> torch.Tensor:
    if use_cuda(x):
        return bi.inv_kernel(ctx, x)
    return bi.inv_mod(ctx, x)


def pow_const(ctx, x: torch.Tensor, exp_bits) -> torch.Tensor:
    """x^e by square-and-multiply (`bigint.pow_const`), each product on
    kernel 1 for a CUDA tensor, the plain product for a CPU tensor."""
    if use_cuda(x):
        return bi.pow_const(ctx, x, exp_bits, lambda a, b: bi.binop_kernel("mul", ctx, a, b))
    return bi.pow_const(ctx, x, exp_bits)
