"""Montgomery arithmetic over 16-bit limbs: plain PyTorch versions and the
wrappers of the CUDA field kernels.

Elements are `[..., L]` int32 tensors of base-2^16 limbs in Montgomery
form (R = 2^(16 L)), the JAX package's layout (`marlin_tpu/ops/bigint.py`).
The same functions serve Fr (L=16; 48 for test_wide750) and Fq (L=16 for
BN254, 24 for the other curves) through a `ModCtx`.

Two implementations of each field op live here:

* the **plain version** (`mont_mul`, `add_mod`, `sub_mod`, `inv_mod`):
  torch integer code computed in int64 — torch on the CPU lacks uint32
  add, shift and compare — that runs on any device.  The CPU path uses it,
  and `chip_smoke.py` holds the kernels against it on the card;
* the **kernel wrappers** (`binop_kernel`, `inv_kernel`): checks, output
  allocation and the launch of `csrc/field.cu` on the current stream.
  The binop reads a broadcast operand in place through a row map
  (`row_map`; `rows_by_map` is the plain version of that read) and copies
  only what no map expresses, counted in `cuda.BINOP_COPIES`.

`ops/routing.py` picks between them by the tensor's device alone.  Outputs
are canonical (< N) in both, so they agree limb for limb with each other
and with the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda
from .limbs import LIMB_BITS, LIMB_MASK, int_to_limbs, limbs_to_int

LIMB_DTYPE = torch.int32
_MAX_NL32 = 24  # csrc/mont.cuh MARLIN_MAX_NL


@dataclass(frozen=True)
class ModCtx:
    """Static per-modulus context: the field ("fr" or "fq"), its modulus,
    its limb count and the curve it belongs to.  The kernels take the field
    and the curve from `kernel_params` and refuse a context that is not the
    one they were compiled for."""

    name: str
    modulus: int
    L: int  # number of 16-bit limbs; R = 2^(16 L)
    curve: str | None = None  # fields/<curve>.py; None: no compiled curve

    @property
    def R(self) -> int:
        return 1 << (LIMB_BITS * self.L)

    @functools.cached_property
    def mont_one(self) -> int:
        return self.R % self.modulus

    @functools.cached_property
    def r2(self) -> int:
        return self.R * self.R % self.modulus

    @functools.cached_property
    def nprime(self) -> int:
        return pow(-self.modulus, -1, self.R)  # -N^{-1} mod R

    @functools.cached_property
    def n_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.L)

    @functools.cached_property
    def nprime_limbs(self) -> np.ndarray:
        return int_to_limbs(self.nprime, self.L)

    @functools.cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2, self.L)

    @functools.cached_property
    def one_limbs(self) -> np.ndarray:
        return int_to_limbs(self.mont_one, self.L)

    @functools.cached_property
    def canonical_one_limbs(self) -> np.ndarray:
        return int_to_limbs(1, self.L)

    @property
    def field_id(self) -> int:
        """The `field` argument of the kernel entries (kFieldFr, kFieldFq)."""
        return cuda.FIELD_IDS[self.name]

    @functools.cached_property
    def kernel_params(self) -> np.ndarray:
        """`ModParams` of csrc/mont.cuh: n[24], np0, one[24], field, curve —
        the modulus, -N^{-1} mod 2^32 and R mod N as 32-bit limbs, then the
        field's and the curve's numbers (0 for a curve without kernels)."""
        nl = self.L // 2
        assert nl <= _MAX_NL32

        def words(x: int) -> list:
            return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(_MAX_NL32)]

        out = words(self.modulus) + [pow(-self.modulus, -1, 1 << 32)] + words(self.mont_one)
        out += [self.field_id, cuda.CURVE_IDS.get(self.curve, 0)]
        return np.asarray(out, dtype=np.uint32)

    def const(self, which: str, device) -> torch.Tensor:
        """[L] int32 limbs of N ("n"), -N^-1 mod R ("nprime"), R^2 mod N
        ("r2"), R mod N ("one") or 1 ("canonical_one") on `device`, cached
        per device."""
        return _const(self, which, torch.device(device))


@functools.lru_cache(maxsize=None)
def _const(ctx: ModCtx, which: str, device: torch.device) -> torch.Tensor:
    arr = {
        "n": ctx.n_limbs,
        "nprime": ctx.nprime_limbs,
        "r2": ctx.r2_limbs,
        "one": ctx.one_limbs,
        "canonical_one": ctx.canonical_one_limbs,
    }[which]
    return torch.as_tensor(arr.astype(np.int32), device=device)


def zeros(ctx: ModCtx, shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((*shape, ctx.L), dtype=LIMB_DTYPE, device=device)


# --------------------------------------------------------------------------
# int64 limb helpers (exact; shared by the plain versions and the glue that
# accumulates redundant sums before one modular reduction)


def normalize(t: torch.Tensor, out_len: int | None = None) -> torch.Tensor:
    """Exact carry propagation over int64 limbs -> base-2^16 limbs.

    Limbs may be redundant (any size below 2^62) and negative; the top limb
    keeps the value's sign and anything beyond 16 bits, so the value is
    preserved exactly when it fits `out_len` limbs.  Parallel carry passes
    repeat until no limb below the top carries."""
    t = t.to(torch.int64)
    if out_len is not None and out_len != t.shape[-1]:
        if out_len > t.shape[-1]:
            t = torch.nn.functional.pad(t, (0, out_len - t.shape[-1]))
        else:
            t = t[..., :out_len]
    t = t.clone()
    if t.shape[-1] < 2:
        return t
    while True:
        carry = t[..., :-1] >> LIMB_BITS
        if not bool(carry.any()):
            return t
        t[..., :-1] &= LIMB_MASK
        t[..., 1:] += carry


def mul_wide(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of normalized [.., L] limbs -> redundant [.., 2L]
    int64 limbs, the JAX package's: each 32-bit partial product adds its
    low half at position i + j and its high half at i + j + 1 (limbs
    < 2L·2^16)."""
    L = x.shape[-1]
    if y.shape[-1] != L:
        raise ValueError(f"mul_wide: {L} and {y.shape[-1]} limbs")
    shape = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    x64, y64 = x.to(torch.int64), y.to(torch.int64)
    acc = torch.zeros((*shape, 2 * L), dtype=torch.int64, device=x.device)
    for i in range(L):
        p = x64[..., i : i + 1] * y64
        acc[..., i : i + L] += p & LIMB_MASK
        acc[..., i + 1 : i + L + 1] += p >> LIMB_BITS
    return acc


def cond_sub_modulus(ctx: ModCtx, v: torch.Tensor) -> torch.Tensor:
    """v (normalized int64, [.., M >= L], 0 <= v < 2N) -> v mod N, [.., M]."""
    v = v.to(torch.int64)
    d = v.clone()
    d[..., : ctx.L] -= ctx.const("n", v.device)
    d = normalize(d)
    keep = d[..., -1] < 0
    return torch.where(keep[..., None], v, d)


# --------------------------------------------------------------------------
# plain versions


def _prep(ctx: ModCtx, *arrs):
    shape = torch.broadcast_shapes(*(a.shape[:-1] for a in arrs))
    return [a.to(torch.int64).expand(*shape, ctx.L) for a in arrs], shape


def mont_mul(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain CIOS Montgomery product a·b·R^-1 mod N (canonical output).

    Interleaved over a's limbs inside a [.., 2L+1] int64 accumulator whose
    window slides one limb per step; a position takes at most L products
    a_i b_j and L products m N_j of 16-bit limbs, each below 2^32, and one
    carry below 2^24, so it stays below 2^39 at L = 48, and no carry
    propagates until the end."""
    L = ctx.L
    (a64, b64), shape = _prep(ctx, a, b)
    n = ctx.const("n", a64.device)
    np0 = ctx.nprime & LIMB_MASK
    acc = torch.zeros((*shape, 2 * L + 1), dtype=torch.int64, device=a64.device)
    for i in range(L):
        win = acc[..., i : i + L]
        win += a64[..., i : i + 1] * b64
        m = (acc[..., i] * np0) & LIMB_MASK
        win += m[..., None] * n
        acc[..., i + 1] += acc[..., i] >> LIMB_BITS
    out = normalize(acc[..., L:])  # value < 2N
    return cond_sub_modulus(ctx, out)[..., :L].to(LIMB_DTYPE)


def add_mod(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (a64, b64), _ = _prep(ctx, a, b)
    s = normalize(a64 + b64, ctx.L + 1)
    return cond_sub_modulus(ctx, s)[..., : ctx.L].to(LIMB_DTYPE)


def sub_mod(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (a64, b64), _ = _prep(ctx, a, b)
    d = normalize(a64 - b64)
    neg = d[..., -1] < 0
    plus_n = normalize(d + ctx.const("n", d.device))
    return torch.where(neg[..., None], plus_n, d).to(LIMB_DTYPE)


def neg_mod(ctx: ModCtx, a: torch.Tensor) -> torch.Tensor:
    return sub_mod(ctx, torch.zeros_like(a), a)


def mont_reduce(ctx: ModCtx, t: torch.Tensor) -> torch.Tensor:
    """Plain SOS Montgomery reduction: T (normalized [.., 2L], T < N·R) ->
    T·R^-1 mod N, canonical [.., L]."""
    L = ctx.L
    t = t.to(torch.int64)
    m = normalize(mul_wide(t[..., :L], ctx.const("nprime", t.device)))[..., :L]  # (T mod R)·N' mod R
    u = normalize(mul_wide(m, ctx.const("n", t.device)) + t, 2 * L)  # low L limbs 0
    return cond_sub_modulus(ctx, u[..., L:]).to(LIMB_DTYPE)


def mont_sqr(ctx: ModCtx, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(ctx, a, a)


def pow_const(ctx: ModCtx, x: torch.Tensor, exp_bits, mul=None) -> torch.Tensor:
    """x^e (Montgomery in/out) for a static exponent given as MSB-first
    bits, by left-to-right square-and-multiply; `mul` is the product
    (default: the plain `mont_mul`)."""
    if mul is None:
        mul = functools.partial(mont_mul, ctx)
    acc = ctx.const("one", x.device).expand_as(x)
    for bit in np.asarray(exp_bits).tolist():
        acc = mul(acc, acc)
        if bit:
            acc = mul(acc, x)
    return acc.contiguous()


def is_zero(ctx: ModCtx, x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(-1)


def eq(ctx: ModCtx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(-1)


def inv_mod(ctx: ModCtx, x: torch.Tensor) -> torch.Tensor:
    """Plain batch inversion (Montgomery in/out); 0 maps to 0.

    Montgomery's trick over the whole batch, as kernel 2 does it over each
    block: zeros enter as one, a product tree goes up level by level (the
    leaves padded with one to a power of two), the root is inverted, and
    its inverse goes back down with two products a node.  The root is one
    element, inverted exactly with a host integer (`pow(a, -1, N)`); a
    Fermat chain of ~380 products on one element costs about a second of
    torch calls on the CPU."""
    L = ctx.L
    flat = x.reshape(-1, L)
    n = flat.shape[0]
    if n == 0:
        return torch.empty_like(x)
    zero = (flat == 0).all(-1, keepdim=True)
    one = ctx.const("one", x.device)
    level = torch.where(zero, one, flat.to(LIMB_DTYPE))
    size = 1 << (n - 1).bit_length()
    if size > n:
        level = torch.cat([level, one.expand(size - n, L)])
    levels = [level]
    while level.shape[0] > 1:
        level = mont_mul(ctx, level[0::2], level[1::2])
        levels.append(level)
    root = limbs_to_int(level[0].cpu().numpy())  # a R mod N
    inv_root = pow(root, -1, ctx.modulus) * ctx.r2 % ctx.modulus  # (a R)^-1 R^2 = a^-1 R
    inv = torch.as_tensor(int_to_limbs(inv_root, L).astype(np.int32), device=x.device)[None]
    for level in reversed(levels[:-1]):
        left, right = level[0::2], level[1::2]
        inv = torch.stack([mont_mul(ctx, inv, right), mont_mul(ctx, inv, left)], dim=1).reshape(-1, L)
    return torch.where(zero, torch.zeros_like(flat, dtype=LIMB_DTYPE), inv[:n]).reshape(x.shape)


# --------------------------------------------------------------------------
# kernel wrappers (csrc/field.cu)

BINOP_KIND = {"mul": 0, "add": 1, "sub": 2}
PLAIN_OPS = {"mul": mont_mul, "add": add_mod, "sub": sub_mod}


def _kernel_operand(t: torch.Tensor, shape) -> torch.Tensor:
    """Broadcast to `shape` and make contiguous and 16-byte aligned (the
    kernels load elements with 16-byte vector loads)."""
    t = t.expand(*shape, t.shape[-1])
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


# kernel 1's two bodies (csrc/field.cu): the widths (32-bit words an
# element) at which a launch stages its operand tiles in shared memory by
# cp.async; at the others (Fr's 8 words) operands load into registers.
# Chosen by timing both at 2^16 on the H100 (tools/kernel_ab.py, the
# `variants` of chip_smoke.py's field_binop row; PERF.md §6).
BINOP_STAGED_WORDS = frozenset({12, 24})
IDENTITY_MAP = (1, 0)  # (div, period): element i reads row i


def row_map(shape, out_shape) -> tuple | None:
    """The row map by which kernel 1 reads an operand of batch shape `shape`
    broadcast to `out_shape` in place: (div, period) such that element i of
    the flattened output reads row (i // div) % period of the operand
    (period 0: row i), or None when one map cannot express the broadcast.

    The dims where the output has size 1 do not count.  Of the others, the
    operand's full dims must be consecutive (no broadcast dim between
    them); `period` is their product and `div` the product of the output's
    dims after them: [1] against [n] is period 1, [len] against [m, len]
    period len, [k, 1] against [k, m] div m and period k."""
    shape = (1,) * (len(out_shape) - len(shape)) + tuple(shape)
    dims = [(s, o) for s, o in zip(shape, out_shape) if o != 1]
    if all(s == o for s, o in dims):
        return IDENTITY_MAP
    full = [i for i, (s, o) in enumerate(dims) if s == o]
    if not full:
        return (1, 1)
    first, last = full[0], full[-1]
    if last - first + 1 != len(full):
        return None
    period = math.prod(o for _, o in dims[first : last + 1])
    div = math.prod(o for _, o in dims[last + 1 :])
    return (div, period)


def rows_by_map(t: torch.Tensor, m: tuple, n: int) -> torch.Tensor:
    """Plain version of kernel 1's operand read: the [n, L] rows that its
    row map `m` gives of t ([.., L], contiguous)."""
    div, period = m
    i = torch.arange(n, device=t.device)
    rows = i if period == 0 else (i // div) % period
    return t.reshape(-1, t.shape[-1])[rows]


def _aligned(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _binop_operand(t: torch.Tensor, shape) -> tuple:
    """(tensor, row map) by which kernel 1 reads operand t of a launch of
    batch shape `shape`: t itself where a row map expresses its broadcast,
    else t made to the full shape (counted in cuda.BINOP_COPIES); a copy
    too of an operand that is not contiguous or 16-byte aligned."""
    m = IDENTITY_MAP if t.shape[:-1] == shape else row_map(t.shape[:-1], shape)
    if m is None:
        cuda.BINOP_COPIES["broadcast"] += 1
        return t.expand(*shape, t.shape[-1]).contiguous(), IDENTITY_MAP
    if not _aligned(t):
        cuda.BINOP_COPIES["layout"] += 1
        t = t.clone(memory_format=torch.contiguous_format)
    return t, m


@functools.lru_cache(maxsize=None)
def _params_ptr(ctx: ModCtx) -> ctypes.c_void_p:
    """The `kernel_params` words of ctx as a launch argument, made once (the
    cached array they point into lives as long as ctx)."""
    return ctx.kernel_params.ctypes.data_as(ctypes.c_void_p)


def binop_kernel(kind: str, ctx: ModCtx, a: torch.Tensor, b: torch.Tensor,
                 staged: bool | None = None) -> torch.Tensor:
    """Kernel 1: elementwise mul/add/sub of broadcastable [.., L] CUDA
    tensors, each operand read in place through its row map.  `staged`
    picks the body (default: by width, BINOP_STAGED_WORDS)."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a, am = _binop_operand(a, shape)
    b, bm = _binop_operand(b, shape)
    for name, t in (("a", a), ("b", b)):
        cuda.require_cuda_field_tensor(t, f"binop_kernel {name}", ctx.L)
    if a.device != b.device:
        raise ValueError("binop_kernel: operands on different devices")
    out = torch.empty((*shape, ctx.L), dtype=LIMB_DTYPE, device=a.device)
    n = out.numel() // ctx.L
    if n == 0:
        return out
    if n >= 1 << 31:
        raise ValueError(f"binop_kernel: {n} elements, the kernel takes fewer than 2^31")
    if staged is None:
        staged = ctx.L // 2 in BINOP_STAGED_WORDS
    err = cuda.lib().marlin_field_binop(
        BINOP_KIND[kind], ctx.field_id, a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
        *am, *bm, int(staged), _params_ptr(ctx), cuda.stream_handle(out),
    )
    cuda.LAUNCHES["field_binop"] += 1
    key = (ctx.name, kind)
    cuda.BINOP_LAUNCHES[key] = cuda.BINOP_LAUNCHES.get(key, 0) + 1
    cuda.check(err, "field_binop")
    return out


def inv_kernel(ctx: ModCtx, x: torch.Tensor) -> torch.Tensor:
    """Kernel 2: batch inversion (0 -> 0) of a [.., L] CUDA tensor, one
    launch."""
    x = _kernel_operand(x, x.shape[:-1])
    cuda.require_cuda_field_tensor(x, "inv_kernel x", ctx.L)
    out = torch.empty_like(x)
    n = out.numel() // ctx.L
    if n == 0:
        return out
    err = cuda.lib().marlin_field_inv(
        ctx.field_id, x.data_ptr(), out.data_ptr(), n, _params_ptr(ctx), cuda.stream_handle(out),
    )
    cuda.LAUNCHES["field_inv"] += 1
    cuda.check(err, "field_inv")
    return out


# --------------------------------------------------------------------------
# compositions (routed through ops/routing.py: kernel on CUDA, plain on CPU)


def to_mont(ctx: ModCtx, x: torch.Tensor) -> torch.Tensor:
    from . import routing

    return routing.binop("mul", ctx, x, ctx.const("r2", x.device))


def from_mont(ctx: ModCtx, x: torch.Tensor) -> torch.Tensor:
    from . import routing

    # mont_mul(x, 1) = x R^-1: the canonical value
    return routing.binop("mul", ctx, x, ctx.const("canonical_one", x.device))


def reduce_wide(ctx: ModCtx, t: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Redundant int64 limbs [.., M] (non-negative, value < N·R) -> value
    mod N as canonical [.., L] limbs.

    With t = lo + hi·R (hi < N): t mod N = lo·R·R^-1 + hi·R²·R^-1, i.e.
    two Montgomery products (by R mod N and by R² mod N) and one add, routed
    by device, or the plain versions on any device with `plain`."""
    from . import routing

    def op(kind, a, b):
        return PLAIN_OPS[kind](ctx, a, b) if plain else routing.binop(kind, ctx, a, b)

    L = ctx.L
    t = normalize(t, 2 * L)
    lo = t[..., :L].to(LIMB_DTYPE).contiguous()
    hi = t[..., L:].to(LIMB_DTYPE).contiguous()
    dev = t.device
    return op("add", op("mul", lo, ctx.const("one", dev)), op("mul", hi, ctx.const("r2", dev)))


def modsum(ctx: ModCtx, x: torch.Tensor, dim: int = 0, plain: bool = False) -> torch.Tensor:
    """Field sum along `dim` of normalized limbs -> canonical limbs.

    Limbs are summed exactly in int64 (exact to ~2^47 terms), then reduced
    once (`reduce_wide`, with `plain` as there)."""
    if x.shape[dim] == 0:
        shape = list(x.shape)
        del shape[dim]
        return torch.zeros(shape, dtype=LIMB_DTYPE, device=x.device)
    s = x.to(torch.int64).sum(dim=dim)
    return reduce_wide(ctx, s, plain)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise field select; cond has the batch shape (no limb axis)."""
    return torch.where(cond[..., None], a, b)
