"""The G1 group law of the active curve on point batches: kernels 4, 5 and 6.

Port of `marlin_tpu/ops/pallas/curve.py`.  A point batch is a tuple
(X, Y, Z) of `[.., L]` int32 Fq Montgomery limb tensors (L = fq.L: 24, or
16 for BN254), Jacobian,
identity <=> Z == 0 (ops/curve_device.py).  Five functions, each as a
kernel wrapper (csrc/curve.cu; the ladder and the combine csrc/chain.cu)
and a plain PyTorch version, routed by the tensor's device alone (a CUDA
tensor launches the kernel or raises, a CPU tensor takes the plain
version):

* `add`: the complete Jacobian add, add-2007-bl with its edge cases
  (`_jac_add_planes`, curve.py:65-107);
* `double`: dbl-2009-l, with Z3 = 0 where Y or Z is 0 (`_double_kernel`);
* `scalar_mul`: s_i·P_i by the MSB-first double-and-add of
  `marlin_tpu/ops/curve_device.py::scalar_mul_batch` (:282), the doubling
  and the complete add above, in one launch;
* `bucket_fold`: the sums of the MSMs' buckets (`_fold_kernel`): each
  bucket lane's slots folded with the mixed add (`_jac_madd_planes`, or
  `_jac_madd_planes_fast`, which reports degeneracy instead of doubling),
  in `fold_subrows` interleaved partial sums that a roll-halving tree of
  complete adds joins;
* `combine_windows`: Σ_w 2^(c·w)·T_w over a classic Pippenger's window sums
  (`_combine_kernel`): window w doubled c·w times, then a halving tree of
  complete adds.

The plain versions follow the TPU formulas product for product over the
plain Fq ops of ops/bigint.py (all canonical, so the grouping of a chain of
adds and subs does not change a residue); their products are stacked into
one call per layer, as `marlin_tpu.ops.curve_device._add_xla` does.  The
kernels equal them limb for limb.
"""

from __future__ import annotations

import ctypes

import torch

from . import bigint as bi
from . import cuda, fq

# partial sums per bucket lane on the table path's folds (one warp a lane):
# the most `fold_subrows` gives (csrc/curve.cu kMaxLogSub).  The Jacobian
# result of a fold depends on the count; its affine result does not.
FOLD_SUBROWS = 32
# threads a fold should keep busy (about two blocks of 128 on each of the
# H100's 132 SMs): lanes take more sub-rows until they reach it
FOLD_THREADS = 1 << 15
# most window sums one combine takes (csrc/chain.cu kCombineMax, and the
# TPU kernel's lane tile)
COMBINE_MAX = 128

_CTX = fq.CTX
_L = fq.L


def _mul(*pairs):
    """One plain Montgomery product call for a layer of independent products."""
    a = torch.stack([x for x, _ in pairs])
    b = torch.stack([y for _, y in pairs])
    return bi.mont_mul(_CTX, a, b).unbind(0)


def _add(a, b):
    return bi.add_mod(_CTX, a, b)


def _sub(a, b):
    return bi.sub_mod(_CTX, a, b)


def _is_zero(a):
    return (a == 0).all(-1)


def _sel(cond, a, b):
    return torch.where(cond[..., None], a, b)


def _expand(coords):
    shape = torch.broadcast_shapes(*(c.shape[:-1] for c in coords))
    return [c.expand(*shape, _L) for c in coords]


# --------------------------------------------------------------------------
# plain versions


def _double_raw(X, Y, Z):
    """dbl-2009-l, a = 0 (curve.py:42-62), no identity select."""
    A, B, YZ = _mul((X, X), (Y, Y), (Y, Z))
    XB = _add(X, B)
    C, t = _mul((B, B), (XB, XB))
    tAC = _sub(_sub(t, A), C)
    D = _add(tAC, tAC)
    E = _add(_add(A, A), A)
    (F,) = _mul((E, E))
    X3 = _sub(F, _add(D, D))
    C4 = _add(_add(C, C), _add(C, C))
    C8 = _add(C4, C4)
    (EDX,) = _mul((E, _sub(D, X3)))
    Y3 = _sub(EDX, C8)
    Z3 = _add(YZ, YZ)
    return X3, Y3, Z3


def double_plain(p):
    """Plain twin of kernel 4's doubling (curve.py:165-170)."""
    X, Y, Z = _expand(p)
    X3, Y3, Z3 = _double_raw(X, Y, Z)
    y_zero = _is_zero(Y) | _is_zero(Z)
    return X3, Y3, _sel(y_zero, torch.zeros_like(Z3), Z3)


def _select_edges(X3, Y3, Z3, p, q, use_dbl, p_inf, q_inf):
    """The complete add's selects (curve.py:100-106); the doubling runs only
    when some lane needs it, which leaves every selected limb the same."""
    if bool(use_dbl.any()):
        dX, dY, dZ = _double_raw(*p)
        X3, Y3, Z3 = _sel(use_dbl, dX, X3), _sel(use_dbl, dY, Y3), _sel(use_dbl, dZ, Z3)
    return tuple(
        _sel(q_inf, p[i], _sel(p_inf, q[i], v)) for i, v in enumerate((X3, Y3, Z3))
    )


def add_plain(p, q):
    """Plain twin of kernel 4's complete add (curve.py:65-107)."""
    X1, Y1, Z1, X2, Y2, Z2 = _expand((*p, *q))
    Z1Z1, Z2Z2 = _mul((Z1, Z1), (Z2, Z2))
    U1, U2, A1, A2 = _mul((X1, Z2Z2), (X2, Z1Z1), (Y1, Z2), (Y2, Z1))
    zsum = _add(Z1, Z2)
    S1, S2, ZZ = _mul((A1, Z2Z2), (A2, Z1Z1), (zsum, zsum))
    H = _sub(U2, U1)
    HH = _add(H, H)
    S2S1 = _sub(S2, S1)
    r = _add(S2S1, S2S1)
    I, rsq, Z3 = _mul((HH, HH), (r, r), (_sub(_sub(ZZ, Z1Z1), Z2Z2), H))
    J, V = _mul((H, I), (U1, I))
    X3 = _sub(_sub(rsq, J), _add(V, V))
    S1J, rVX = _mul((S1, J), (r, _sub(V, X3)))
    Y3 = _sub(rVX, _add(S1J, S1J))
    p_inf, q_inf = _is_zero(Z1), _is_zero(Z2)
    use_dbl = _is_zero(H) & _is_zero(S2S1) & ~p_inf & ~q_inf
    return _select_edges(X3, Y3, Z3, (X1, Y1, Z1), (X2, Y2, Z2), use_dbl, p_inf, q_inf)


def madd_plain(p, x2, y2, exact: bool):
    """Jacobian p + affine (x2, y2, 1): `_jac_madd_planes` (exact) or
    `_jac_madd_planes_fast`.  -> (point, degenerate [batch] bool): the fast
    variant's result is not the sum where `degenerate` is set (P == Q)."""
    X1, Y1, Z1 = p
    (Z1Z1,) = _mul((Z1, Z1))
    U2, A2 = _mul((x2, Z1Z1), (y2, Z1))
    (S2,) = _mul((A2, Z1Z1))
    H = _sub(U2, X1)
    HH = _add(H, H)
    S2S1 = _sub(S2, Y1)
    r = _add(S2S1, S2S1)
    I, rsq, Z3 = _mul((HH, HH), (r, r), (_add(Z1, Z1), H))
    J, V = _mul((H, I), (X1, I))
    X3 = _sub(_sub(rsq, J), _add(V, V))
    S1J, rVX = _mul((Y1, J), (r, _sub(V, X3)))
    Y3 = _sub(rVX, _add(S1J, S1J))
    p_inf = _is_zero(Z1)
    deg = _is_zero(H) & _is_zero(S2S1) & ~p_inf
    one = _CTX.const("one", Z1.device).expand_as(Z1)
    no = torch.zeros_like(p_inf)
    if exact:
        return _select_edges(X3, Y3, Z3, p, (x2, y2, one), deg, p_inf, no), no
    return _select_edges(X3, Y3, Z3, p, (x2, y2, one), no, p_inf, no), deg


def _scalar_operands(points, scalar_limbs, num_bits: int):
    """Points and [.., 16] canonical scalar limbs broadcast to one batch
    shape -> (shape, three [n, L] coordinates, [n, 16] limbs)."""
    if not 0 <= num_bits <= 16 * scalar_limbs.shape[-1]:
        raise ValueError(f"scalar_mul: {num_bits} bits for {scalar_limbs.shape[-1]} 16-bit limbs")
    shape = torch.broadcast_shapes(*(c.shape[:-1] for c in points), scalar_limbs.shape[:-1])
    coords = [c.expand(*shape, _L).reshape(-1, _L) for c in points]
    scal = scalar_limbs.expand(*shape, scalar_limbs.shape[-1]).reshape(-1, scalar_limbs.shape[-1])
    return shape, coords, scal


def scalar_mul_plain(points, scalar_limbs: torch.Tensor, num_bits: int = 255):
    """Plain twin of kernel 4's scalar multiple: see `scalar_mul`.  The add
    runs only on the points whose bit is set, which keeps the limbs of the
    add-then-select loop it replaces."""
    shape, P, scal = _scalar_operands(points, scalar_limbs, num_bits)
    acc = list(_identity((P[0].shape[0],), P[0].device))
    for k in range(num_bits - 1, -1, -1):
        acc = list(double_plain(tuple(acc)))
        idx = (((scal[:, k // 16] >> (k % 16)) & 1) == 1).nonzero(as_tuple=True)[0]
        if idx.numel():
            out = add_plain(tuple(a[idx] for a in acc), tuple(p[idx] for p in P))
            for a, o in zip(acc, out):
                a[idx] = o
    return tuple(a.reshape(*shape, _L) for a in acc)


def pack_points_xy(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[.., L] X and Y limbs -> [.., L] packed rows: column p < L/2 holds X
    limbs (2p, 2p+1) as lo | hi << 16, columns L/2.. the same for Y — each
    coordinate as L/2 32-bit limbs, stored as int32 bit patterns (96 B per
    row at L = 24, 64 B at 16: half the gathered bytes of the limb layout)."""
    w = torch.cat([x[..., 0::2], y[..., 0::2]], -1).to(torch.int64)
    w = w | (torch.cat([x[..., 1::2], y[..., 1::2]], -1).to(torch.int64) << 16)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def unpack_xy_rows(g: torch.Tensor) -> tuple:
    """[.., L] packed rows -> ([.., L] X, [.., L] Y) limbs (`_unpack_xy_rows`)."""
    w = g.to(torch.int64) & 0xFFFFFFFF
    limbs = torch.stack([w & 0xFFFF, w >> 16], -1).reshape(*g.shape[:-1], 2 * _L)
    limbs = limbs.to(torch.int32)
    return limbs[..., :_L], limbs[..., _L:]


def _identity(shape, device):
    zero = torch.zeros((*shape, _L), dtype=torch.int32, device=device)
    return zero, _CTX.const("one", device).expand(*shape, _L).clone(), zero.clone()


def fold_subrows(lanes: int, cap: int) -> int:
    """Sub-rows (partial sums) per bucket lane of a [lanes, cap] fold: the
    fewest that give the fold about FOLD_THREADS threads, at most
    FOLD_SUBROWS and at most cap (powers of two).  Long table-path lanes
    ([1539, 3552]) keep 32; the classic path's many short lanes
    ([16384, 128]) take 2, and one where lanes alone fill the card: each
    sub-row costs its share of the join tree, which on a short lane would
    outweigh the slots."""
    want = -(-FOLD_THREADS // max(lanes, 1))
    most = min(FOLD_SUBROWS, 1 << (max(cap, 1).bit_length() - 1))
    return min(1 << (want - 1).bit_length(), most)


def bucket_fold_plain(table: torch.Tensor, layout: torch.Tensor, exact: bool = False,
                      subrows: int | None = None):
    """Plain twin of kernel 5: see `bucket_fold`."""
    lanes, cap = layout.shape
    R = fold_subrows(lanes, cap) if subrows is None else _check_subrows(subrows)
    steps = -(-cap // R)
    lay = torch.nn.functional.pad(layout, (0, steps * R - cap)).reshape(lanes, steps, R)
    acc = list(_identity((lanes, R), layout.device))
    deg = torch.zeros((lanes, R), dtype=torch.bool, device=layout.device)
    for t in range(steps):
        e = lay[:, t]
        idx = (e != 0).nonzero(as_tuple=True)
        if idx[0].numel() == 0:
            continue
        ev = e[idx]
        x2, y2 = unpack_xy_rows(table[ev.abs().to(torch.int64) - 1])
        y2 = torch.where((ev < 0)[:, None], bi.neg_mod(_CTX, y2), y2)
        out, d = madd_plain(tuple(a[idx] for a in acc), x2, y2, exact)
        for a, o in zip(acc, out):
            a[idx] = o
        deg[idx] |= d
    s = R // 2
    while s >= 1:
        out = add_plain(tuple(a[:, :s] for a in acc), tuple(a[:, s : 2 * s] for a in acc))
        for a, o in zip(acc, out):
            a[:, :s] = o
        s //= 2
    return tuple(a[:, 0].contiguous() for a in acc), deg.any(-1).sum()


def _check_subrows(subrows: int) -> int:
    if subrows < 1 or subrows > FOLD_SUBROWS or subrows & (subrows - 1):
        raise ValueError(f"bucket_fold: {subrows} sub-rows, expected a power of two <= {FOLD_SUBROWS}")
    return subrows


def _combine_operands(stacked):
    """[W, 1] (or [W]) stacked Jacobian sums -> three [W, L] tensors."""
    W = stacked[0].shape[0]
    if not 1 <= W <= COMBINE_MAX:
        raise ValueError(f"combine_windows: {W} window sums, expected 1 to {COMBINE_MAX}")
    return [t.reshape(W, _L) for t in stacked]


def combine_windows_plain(stacked, c: int):
    """Plain twin of kernel 6: see `combine_windows`."""
    pts = [t.clone() for t in _combine_operands(stacked)]
    W = pts[0].shape[0]
    for k in range(c * (W - 1)):
        w0 = k // c + 1  # the lanes w with c·w > k double at step k
        for t, v in zip(pts, double_plain(tuple(t[w0:] for t in pts))):
            t[w0:] = v
    size = 1 << (W - 1).bit_length()
    ident = _identity((size - W,), pts[0].device)
    acc = [torch.cat([t, i]) for t, i in zip(pts, ident)]
    s = size // 2
    while s >= 1:
        out = add_plain(tuple(a[:s] for a in acc), tuple(a[s : 2 * s] for a in acc))
        for a, o in zip(acc, out):
            a[:s] = o
        s //= 2
    return tuple(a[0:1].contiguous() for a in acc)


# --------------------------------------------------------------------------
# kernel wrappers (csrc/curve.cu)


def _operands(coords, name):
    shape = torch.broadcast_shapes(*(c.shape[:-1] for c in coords))
    out = [bi._kernel_operand(c, shape) for c in coords]
    for i, t in enumerate(out):
        cuda.require_cuda_field_tensor(t, f"{name} operand {i}", _L)
        if t.device != out[0].device:
            raise ValueError(f"{name}: operands on different devices")
    return out, shape


def add_kernel(p, q):
    """Kernel 4: the complete add of broadcastable point batches."""
    ops, shape = _operands((*p, *q), "g1_add")
    out = [torch.empty((*shape, _L), dtype=torch.int32, device=ops[0].device) for _ in range(3)]
    n = out[0].numel() // _L
    if n == 0:
        return tuple(out)
    err = cuda.lib().marlin_g1_add(
        *(t.data_ptr() for t in ops), *(t.data_ptr() for t in out), n, cuda.stream_handle(out[0])
    )
    cuda.LAUNCHES["g1_add"] += 1
    cuda.check(err, "g1_add")
    return tuple(out)


def double_kernel(p):
    """Kernel 4: the doubling of a point batch."""
    ops, shape = _operands(p, "g1_double")
    out = [torch.empty((*shape, _L), dtype=torch.int32, device=ops[0].device) for _ in range(3)]
    n = out[0].numel() // _L
    if n == 0:
        return tuple(out)
    err = cuda.lib().marlin_g1_double(
        *(t.data_ptr() for t in ops), *(t.data_ptr() for t in out), n, cuda.stream_handle(out[0])
    )
    cuda.LAUNCHES["g1_double"] += 1
    cuda.check(err, "g1_double")
    return tuple(out)


def scalar_mul_kernel(points, scalar_limbs: torch.Tensor, num_bits: int = 255):
    """Kernel 4: the whole double-and-add ladder in one launch (csrc/chain.cu),
    four lanes of a warp a point."""
    shape, coords, scal = _scalar_operands(points, scalar_limbs, num_bits)
    coords = [c.contiguous() for c in coords]
    scal = scal.contiguous()
    for i, t in enumerate(coords):
        cuda.require_cuda_field_tensor(t, f"g1_scalar_mul coordinate {i}", _L)
        if t.device != coords[0].device:
            raise ValueError("g1_scalar_mul: coordinates on different devices")
    if not scal.is_cuda or scal.device != coords[0].device or scal.dtype != torch.int32:
        raise ValueError("g1_scalar_mul: scalars must be int32 limbs on the points' device")
    if scal.shape[-1] != 16:
        raise ValueError(f"g1_scalar_mul: expected 16 scalar limbs, got {scal.shape[-1]}")
    n = coords[0].shape[0]
    out = [torch.empty((n, _L), dtype=torch.int32, device=coords[0].device) for _ in range(3)]
    if n:
        err = cuda.lib().marlin_g1_scalar_mul(
            *(t.data_ptr() for t in coords), scal.data_ptr(), num_bits,
            *(t.data_ptr() for t in out), n, cuda.stream_handle(out[0]),
        )
        cuda.LAUNCHES["g1_scalar_mul"] += 1
        cuda.check(err, "g1_scalar_mul")
    return tuple(t.reshape(*shape, _L) for t in out)


def bucket_fold_kernel(table: torch.Tensor, layout: torch.Tensor, exact: bool = False,
                       subrows: int | None = None):
    """Kernel 5: see `bucket_fold`."""
    cuda.require_cuda_field_tensor(table, "bucket_fold table", _L)
    if table.dim() != 2:
        raise ValueError(f"bucket_fold: the table is [rows, {_L}] packed rows")
    if not layout.is_cuda or layout.device != table.device:
        raise ValueError("bucket_fold: the layout must be a CUDA tensor beside the table")
    if layout.dtype != torch.int32 or layout.dim() != 2 or not layout.is_contiguous():
        raise ValueError("bucket_fold: the layout is a contiguous [lanes, cap] int32 tensor")
    lanes, cap = layout.shape
    R = fold_subrows(lanes, cap) if subrows is None else _check_subrows(subrows)
    if lanes * cap and int(layout.abs().max()) > table.shape[0]:
        raise ValueError("bucket_fold: a layout entry points past the table")
    out = [torch.empty((lanes, _L), dtype=torch.int32, device=table.device) for _ in range(3)]
    flags = torch.zeros(lanes, dtype=torch.int32, device=table.device)
    if lanes == 0:
        return tuple(out), flags.sum()
    err = cuda.lib().marlin_bucket_fold(
        int(exact), table.data_ptr(), layout.data_ptr(), lanes, cap, R.bit_length() - 1,
        *(t.data_ptr() for t in out), flags.data_ptr(), cuda.stream_handle(table),
    )
    cuda.LAUNCHES["bucket_fold"] += 1
    cuda.check(err, "bucket_fold")
    return tuple(out), flags.sum()


def combine_windows_kernel(stacked, c: int):
    """Kernel 6 (csrc/chain.cu), four lanes of a warp a window: see
    `combine_windows`."""
    coords = [t.contiguous() for t in _combine_operands(stacked)]
    for i, t in enumerate(coords):
        cuda.require_cuda_field_tensor(t, f"combine_windows coordinate {i}", _L)
        if t.device != coords[0].device:
            raise ValueError("combine_windows: coordinates on different devices")
    if c < 0:
        raise ValueError(f"combine_windows: window width {c}")
    W = coords[0].shape[0]
    out = [torch.empty((1, _L), dtype=torch.int32, device=coords[0].device) for _ in range(3)]
    err = cuda.lib().marlin_combine_windows(
        *(t.data_ptr() for t in coords), W, c, *(t.data_ptr() for t in out),
        cuda.stream_handle(out[0]),
    )
    cuda.LAUNCHES["combine_windows"] += 1
    cuda.check(err, "combine_windows")
    return tuple(out)


# the kernels of `kernel_info`: (entry, which) by name
KERNEL_INFO = {
    "g1_add": ("marlin_curve_kernel_info", 0), "g1_double": ("marlin_curve_kernel_info", 1),
    "bucket_fold": ("marlin_curve_kernel_info", 2), "bucket_fold_exact": ("marlin_curve_kernel_info", 3),
    "g1_scalar_mul": ("marlin_chain_kernel_info", 0), "combine_windows": ("marlin_chain_kernel_info", 1),
}


def kernel_info() -> dict:
    """name -> registers, local memory bytes (stack frame and spills) and
    resident blocks an SM of each curve kernel, from the CUDA runtime
    (`cudaFuncGetAttributes`, the occupancy calculator)."""
    out = {}
    for name, (entry, which) in KERNEL_INFO.items():
        vals = [ctypes.c_int(0) for _ in range(3)]
        err = getattr(cuda.lib(), entry)(which, *(ctypes.byref(v) for v in vals))
        cuda.check(err, f"kernel_info {name}")
        out[name] = dict(zip(("registers", "local_bytes", "blocks_per_sm"), (v.value for v in vals)))
    return out


# --------------------------------------------------------------------------
# routed entry points


def add(p, q):
    """Complete Jacobian add of broadcastable point batches."""
    return add_kernel(p, q) if p[0].is_cuda else add_plain(p, q)


def double(p):
    """Jacobian doubling of a point batch (identity stays identity)."""
    return double_kernel(p) if p[0].is_cuda else double_plain(p)


def scalar_mul(points, scalar_limbs: torch.Tensor, num_bits: int = 255):
    """Elementwise s_i·P_i of a point batch (MSB-first double-and-add).

    scalar_limbs: [.., 16] canonical (not Montgomery) 16-bit Fr limbs,
    broadcast against the points.  From the identity (0, 1, 0), for bit
    k = num_bits-1 .. 0: acc = double(acc), then acc = add(acc, P_i) where
    bit k of s_i is set."""
    if points[0].is_cuda:
        return scalar_mul_kernel(points, scalar_limbs, num_bits)
    return scalar_mul_plain(points, scalar_limbs, num_bits)


def bucket_fold(table: torch.Tensor, layout: torch.Tensor, exact: bool = False):
    """Σ over each bucket lane's slots of signed table points.

    table: [rows, L] `pack_points_xy` rows of affine points.  layout:
    [lanes, cap] int32, lane-major: entry (b, j) is slot j of bucket lane b —
    0 = empty, +k = table row k-1, -k = its negation (G1 has prime order, so
    y != 0 for every real point).  Sub-row r of a lane's S =
    `fold_subrows(lanes, cap)` sums the slots j = r mod S with the mixed add,
    from the identity; the partial sums then join in a roll-halving tree of
    complete adds (row r takes row r + s for s = S/2, ..., 1).  With
    exact=False the mixed add has no doubling branch, and a lane where it
    met P == Q counts in the returned flag.

    -> ([lanes]-batch point of bucket sums, 0-d count of flagged lanes)."""
    if table.is_cuda:
        return bucket_fold_kernel(table, layout, exact)
    return bucket_fold_plain(table, layout, exact)


def combine_windows(stacked, c: int):
    """Σ_w 2^(c·w)·T_w over W <= 128 window sums -> a [1]-batch point.

    stacked: (X, Y, Z) of [W, 1, L] (or [W, L]) Jacobian limbs.  Window w
    doubles c·w times (Y = 0 or Z = 0 gives the identity, as `double`), then
    lanes join in a halving tree of complete adds: at level s (powers of two
    down from half the next power of two >= W), lane w < s takes lane w + s
    where that lane exists.  The Jacobian result follows that order; its
    affine point is the Horner sum's."""
    if stacked[0].is_cuda:
        return combine_windows_kernel(stacked, c)
    return combine_windows_plain(stacked, c)
