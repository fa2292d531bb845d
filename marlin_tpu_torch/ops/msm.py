"""Multi-scalar multiplication: the classic Pippenger, the fixed-base table
MSM and the host route.

Port of `marlin_tpu/ops/msm.py`.  On one device, three routes, chosen by
the caller's tensors and by whether it has a table:

* The classic Pippenger (`msm_pippenger`, msm.py:219-302, and its
  fully-on-device twin `pippenger_device`, :445-492): unsigned radix-2^c
  windows over the points themselves.  Each window's entries are sorted into
  buckets on the card (`_window_layout_device`), kernel 5 sums each bucket
  (ops/curve.py::bucket_fold over `pack_points_xy` rows of the points), two
  Hillis-Steele scans of kernel-4 adds turn the bucket sums into
  T_w = Σ_b b·S_b, and kernel 6 (ops/curve.py::combine_windows) adds up
  Σ_w 2^(c·w)·T_w.  A window whose largest bucket would overflow its
  capacity (the narrow top window, repeated scalars) takes masked sums
  instead (`_skewed_windows`).  It carries the exact public `msm()` on the
  card, `msm_many` without a table, and the exact rerun after a fold flag.
* The table path (:505-990), the route of every commit and opening MSM of
  the prover on an SRS on the card.  All of a prove's MSMs run over the
  fixed SRS powers, so the windows collapse into ONE signed-digit window
  over a table of 2^(c·w)-scaled copies of the powers
  (`build_fixed_table`).  Every job of a round is cut into balanced signed
  digits, its (window, point) entries are sorted into buckets
  (`_merged_layouts_batched`), kernel 5 sums each bucket, and the same two
  scans give Σ_b b·S_b.  The top window spans only the modulus's high bits
  and folds apart with its own narrow bucket space.  Jobs under 512 points,
  and tails of at most `_TAIL_MAX` points past a `_FIXED_QUANT` boundary,
  run through one shared ladder over the table's window rows
  (`_shared_ladder`): c-bit digits, not 255-bit scalars.
* The host route, for points on the CPU: the native C Pippenger for
  BLS12-381, the host Python Pippenger of `hc.g1_msm` for the other curves
  (`_host_msm`).  The route follows the tensors' device alone; the port does not read the JAX
  package's `MARLIN_TPU_HOST_MSM` switch (msm.py:1035, :1101-1112), which
  would move the card's MSMs to the host.

Under a mesh (parallel/context.py) `msm` and `msm_many` route batches of
at least `MSM_MIN_SHARDED` points to the distributed Pippenger
(parallel/msm_sharded.py, `_sharded_msm_or_none`), whose window-sharded
body folds its block of windows here (`pippenger_device_window_block`),
and the table is passed over.

Correctness contract (msm.py:197-216): a bucket that overflows its
capacity, and a fast mixed add that met P == Q, each leave a nonzero flag
in `_FOLD_FLAGS`.  The commit path reads the flags with its results
(snark/kzg.py::_run_msm_jobs) and reruns the batch on the classic path with
exact=True (complete mixed adds; no table, whose capacity model is what
failed).  The public `msm()` checks the flags of its own call.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..fields import active as P
from ..fields import host_curve as hc
from ..fields import native_curve as nc
from . import bigint as bi
from . import curve
from . import curve_device as cd
from . import fq, fr
from .limbs import ints_to_limbs

FR_BITS = P.FR_BITS

# below this size the ladder beats the classic Pippenger (fewer launches)
_PIPPENGER_MIN = 1 << 10


def _host_msm(points: cd.Point, scalars_mont: torch.Tensor) -> cd.Point:
    """The host route, for points on the CPU: the native C Pippenger for
    BLS12-381 (which raises if that library failed to build), the host
    Python group law of `hc.g1_msm` for a curve the C runtime does not
    carry, as in the JAX package (host_curve.py:285).  A card tensor never
    takes it."""
    if points[0].is_cuda:
        raise ValueError("the host MSM takes CPU tensors; card tensors run on the card")
    if P.CURVE_NAME == "bls12_381" and not nc.available():
        raise RuntimeError("the native curve library (csrc/marlin_curve.c) failed to build")
    affs = cd.to_affine_ints_host(points)
    scals = fr.to_ints(scalars_mont)
    res = hc.g1_msm(affs, scals)
    return cd.from_affine_ints([res], scalars_mont.device)


def _sharded_msm_or_none(points: cd.Point, scalars_mont: torch.Tensor):
    """The distributed MSM (parallel/msm_sharded.py) when a mesh is active
    and the batch holds at least `MSM_MIN_SHARDED` points, padded with
    identity points and zero scalars to divide over the mesh (msm.py:1000);
    else None."""
    from ..parallel import context as pctx

    ctx = pctx.current()
    n = points[0].shape[0]
    # a size: the same on every rank of a mesh spanning processes
    if ctx is None or n < pctx.MSM_MIN_SHARDED:
        return None
    from ..parallel.msm_sharded import msm_sharded

    pad = -n % ctx.num_devices
    if pad:
        ident = cd.identity((pad,), points[0].device)
        points = tuple(torch.cat([points[i], ident[i]]) for i in range(3))
        scalars_mont = torch.nn.functional.pad(scalars_mont, (0, 0, 0, pad))
    return msm_sharded(points, scalars_mont, ctx.mesh, ctx.axis)


def msm(
    points: cd.Point, scalars_mont: torch.Tensor, c: int | None = None, exact: bool = False
) -> cd.Point:
    """Σ_i s_i P_i -> single Jacobian point (shape [1]); always exact.

    points: [n] Jacobian batch (any Z; Z = 0 is the identity);
    scalars_mont: [n, 16] Fr Montgomery limbs.  Points on the card run on
    the card: the ladder below `_PIPPENGER_MIN` points, else the classic
    Pippenger, which this call reruns with exact=True when a flag of its own
    fired (msm.py:1048-1076).  Points on the CPU take the host route.
    Under a mesh (parallel/context.py) a large enough batch runs sharded."""
    out = _sharded_msm_or_none(points, scalars_mont)
    if out is not None:
        return out
    if not points[0].is_cuda:
        return _host_msm(points, scalars_mont)
    if points[0].shape[0] < _PIPPENGER_MIN:
        return msm_ladder(points, scalars_mont)
    n_flags = len(_FOLD_FLAGS)
    out = msm_pippenger(points, scalars_mont, c, exact=exact)
    if not exact:
        new = _FOLD_FLAGS[n_flags:]
        del _FOLD_FLAGS[n_flags:]
        if new and bool(torch.stack(new).any()):
            out = msm_pippenger(points, scalars_mont, c, exact=True)
    return out


def msm_many(powers: cd.Point, jobs: list, exact: bool = False, table=None) -> list:
    """Several MSMs over slices of one point array.

    jobs: list of (offset, scalars_mont [n_j, 16]) — the points of job j are
    powers[offset : offset+n_j].  With a FixedBaseTable the batch runs on
    the table path.  Without one, powers on the card run each job on the
    classic Pippenger when the batch holds at least `_PIPPENGER_MIN` points,
    else all jobs on one shared ladder with a tree reduction per job
    (msm.py:1113-1139); powers on the CPU take the host route per job.
    Under a mesh (parallel/context.py) the table is passed over and, in a
    batch of at least `_PIPPENGER_MIN` points, each large enough job runs
    sharded (msm.py:1096-1121).  Fast-fold flags queue in `_FOLD_FLAGS`
    for the caller."""
    from ..parallel import context as pctx

    if not jobs:
        return []
    if table is not None and pctx.current() is None:
        return msm_fixed_many(table, jobs, exact=exact)

    def points_of(off, scal):
        return tuple(powers[i][off : off + scal.shape[0]] for i in range(3))

    # sizes: every rank of a mesh spanning processes takes the same route
    big = sum(scal.shape[0] for _, scal in jobs) >= _PIPPENGER_MIN

    def one_job(off, scal):
        pts = points_of(off, scal)
        out = _sharded_msm_or_none(pts, scal) if big else None
        if out is not None:
            return out
        if not powers[0].is_cuda:
            return _host_msm(pts, scal)
        return msm_pippenger(pts, scal, exact=exact)

    if big or not powers[0].is_cuda:
        return [one_job(off, scal) for off, scal in jobs]
    parts = [points_of(off, scal) for off, scal in jobs]
    pts = tuple(torch.cat([p[i] for p in parts]) for i in range(3))
    scal = torch.cat([s for _, s in jobs])
    muls = cd.scalar_mul_batch(pts, bi.from_mont(fr.CTX, scal), FR_BITS)
    out, start = [], 0
    for _, s in jobs:
        stop = start + s.shape[0]
        out.append(cd.tree_reduce_add(tuple(m[start:stop] for m in muls)))
        start = stop
    return out


def fixed_base_powers(base_affine: tuple, scalar_ints: list, device) -> cd.Point:
    """[s_0·G, s_1·G, ...] as a Jacobian batch on `device` — one batched
    double-and-add (msm.py:1142) of the one base against every scalar."""
    base = cd.from_affine_ints([base_affine], device)
    limbs = ints_to_limbs([s % P.R_MODULUS for s in scalar_ints], fr.L).astype(np.int32)
    return cd.scalar_mul_batch(base, torch.as_tensor(limbs, device=base[0].device), FR_BITS)


# --------------------------------------------------------------------------
# fold flags


# Flags of the table path (0-d device tensors: degenerate fast madds plus
# spilled bucket entries).  They queue here so that the hot path never waits
# for the card; kzg._run_msm_jobs fetches them with its results.
_FOLD_FLAGS: list = []


def fold_flags_fired() -> bool:
    """Drain the pending flags; True if any fired (one device-to-host copy)."""
    flags = pending_fold_flags()
    return bool(torch.stack(flags).any()) if flags else False


def pending_fold_flags() -> list:
    """The queued flag tensors, clearing the queue — for a caller that
    copies them to the host together with its results."""
    flags = list(_FOLD_FLAGS)
    _FOLD_FLAGS.clear()
    return flags


# --------------------------------------------------------------------------
# the fixed-base table


class FixedBaseTable:
    """table[w·N + i] = 2^(c·w)·P_i in affine form, as ONE [W·N, fq.L] array
    of `curve.pack_points_xy` rows (X and Y as 32-bit limbs: 96 B a row, 64 B
    for BN254)."""

    def __init__(self, xy: torch.Tensor, c: int, num_windows: int, n_base: int):
        self.xy = xy
        self.c = c
        self.num_windows = num_windows
        self.n_base = n_base


def _fixed_c(n_base: int) -> int:
    """Signed-window width of the table path: 10 up to 2^17 powers, then
    wider (the JAX package's measured choice, msm.py:539-561), unless
    MARLIN_TPU_FIXED_C sets it (read at every call, as there)."""
    env = os.environ.get("MARLIN_TPU_FIXED_C")
    if env:
        return int(env)
    return min(13, max(10, 10 + (n_base.bit_length() - 17) * 3 // 2))


def fixed_table_windows(c: int) -> int:
    """Signed windows for the table path: c·W >= FR_BITS + 1 leaves the
    balanced recoding's last carry a window to land in."""
    return -(-(FR_BITS + 1) // c)


def build_fixed_table(points: cd.Point, c: int) -> FixedBaseTable:
    """The W blocks 2^(c·w)·P of the powers P (affine form, Z in {0, 1}).

    The doubling chain runs in Jacobian coordinates and ONE normalization
    over all blocks (one inversion launch) brings them to affine form: the
    affine points are the JAX package's, which normalizes each block."""
    n_base = points[0].shape[0]
    num_windows = fixed_table_windows(c)
    blocks = []
    cur = points
    for _ in range(1, num_windows):
        for _ in range(c):
            cur = cd.double(cur)
        blocks.append(cur)
    xy = [curve.pack_points_xy(points[0], points[1])]
    if blocks:
        x, y, _ = cd.normalize_batch(tuple(torch.cat([b[i] for b in blocks]) for i in range(3)))
        xy.append(curve.pack_points_xy(x, y))
    return FixedBaseTable(torch.cat(xy).contiguous(), c, num_windows, n_base)


# --------------------------------------------------------------------------
# digits and bucket layouts


def _digit_rows(scal16: torch.Tensor, c: int, windows) -> torch.Tensor:
    """[len(windows), ..] radix-2^c digits (int64) of canonical [.., 16]-limb
    scalars, all windows at once: window w is bits w·c .. w·c + c - 1
    (c <= 16, so two limbs hold it; past the top limb the bits are 0)."""
    off = torch.as_tensor(list(windows), dtype=torch.int64, device=scal16.device) * c
    limbs = torch.nn.functional.pad(scal16.to(torch.int64), (0, 1))
    lo, hi = limbs[..., off // 16], limbs[..., off // 16 + 1]
    return (((lo | (hi << 16)) >> (off % 16)) & ((1 << c) - 1)).movedim(-1, 0).contiguous()


def _digits(scal16: torch.Tensor, c: int, w: int) -> torch.Tensor:
    """Window-w radix-2^c digit (int64) of canonical [.., 16]-limb scalars."""
    return _digit_rows(scal16, c, [w])[0]


def _signed_digits(scal16: torch.Tensor, c: int, num_windows: int) -> torch.Tensor:
    """[W, ..] int32 balanced signed digits in [-(2^(c-1)-1), 2^(c-1)]:
    digit w is raw_w + carry_w - 2^c carry_(w+1), where a window carries out
    when raw + carry in > 2^(c-1).  A raw digit above 2^(c-1) carries out
    whatever comes in, one below does not, and one equal passes its carry
    in on: so the carry out of window w is that of the last window <= w
    whose raw digit is not 2^(c-1) (none: 0), which a running max over
    the windows finds for all of them at once."""
    half, full = 1 << (c - 1), 1 << c
    raw = _digit_rows(scal16, c, range(num_windows))
    w = torch.arange(num_windows, device=raw.device).reshape(-1, *([1] * (raw.dim() - 1)))
    last = torch.where(raw != half, w, -1).cummax(0).values
    out = torch.where(last >= 0, torch.gather(raw > half, 0, last.clamp(min=0)), False).to(torch.int64)
    carry_in = torch.cat([torch.zeros_like(out[:1]), out[:-1]])
    return (raw + carry_in - out * full).to(torch.int32)


def _sort_buckets(bucket: torch.Tensor, enc: torch.Tensor, nb: int):
    """Stable per-window bucket sort of [J, Wm, n] entries -> (encodings in
    bucket order [J·Wm, n], first entry of each bucket [J, Wm, nb], counts
    [J, Wm, nb])."""
    J, Wm, n = bucket.shape
    flat = bucket.reshape(J * Wm, n)
    b_sorted, order = torch.sort(flat, dim=1, stable=True)
    e_sorted = torch.gather(enc.reshape(J * Wm, n), 1, order)
    bounds = torch.arange(nb, dtype=b_sorted.dtype, device=flat.device).expand(J * Wm, nb)
    starts = torch.searchsorted(b_sorted, bounds.contiguous(), side="left")
    ends = torch.cat([starts[:, 1:], torch.full_like(starts[:, :1], n)], dim=1)
    return e_sorted, starts.reshape(J, Wm, nb), (ends - starts).reshape(J, Wm, nb)


def _stitch_layouts(e_sorted, starts, counts, cap: int):
    """Merged lane-major layouts [J, nb, cap] (0 = empty, ±k = table row
    k-1) and the spill count: slot j of bucket b holds the j-th entry of b
    over windows 0, 1, ... in order.  Bucket 0 (digit 0) stays empty."""
    J, Wm, nb = counts.shape
    n = e_sorted.shape[1]
    dev = counts.device
    cnt = counts.transpose(1, 2)  # [J, nb, Wm]
    incl = cnt.cumsum(-1)
    total = incl[..., -1]  # [J, nb]
    col = torch.arange(cap, device=dev)
    w = torch.searchsorted(
        incl.reshape(J * nb, Wm).contiguous(), col.expand(J * nb, cap).contiguous(), right=True
    ).reshape(J, nb, cap).clamp(max=Wm - 1)
    first = torch.gather(starts.transpose(1, 2), 2, w)
    before = torch.gather(incl - cnt, 2, w)
    pos = (first + col - before).clamp(0, n - 1)
    row = w + (torch.arange(J, device=dev) * Wm)[:, None, None]
    have = (col < total[..., None]) & (torch.arange(nb, device=dev) != 0)[None, :, None]
    layouts = torch.where(have, e_sorted.reshape(-1)[row * n + pos], 0).to(torch.int32)
    spill = (total[:, 1:] - cap).clamp(min=0).sum()
    return layouts, spill


def _merged_layouts_batched(bucket: torch.Tensor, enc: torch.Tensor, nb: int, cap: int):
    """[J, Wm, n] bucket indices and ±encoded table indices -> (lane-major
    layouts [J, nb, cap], spill count).  Port of msm.py:716: one batched
    stable sort per (job, window) row, one batched bucket search, then each
    bucket's slots stitched from its per-window segments."""
    e_sorted, starts, counts = _sort_buckets(bucket, enc, nb)
    return _stitch_layouts(e_sorted, starts, counts, cap)


@functools.lru_cache(maxsize=None)
def _top_digit_pmax(c: int, num_windows: int) -> tuple:
    """(max bucket index, max single-digit probability) of the top-window
    digit for scalars uniform below the modulus."""
    r = P.R_MODULUS
    s = c * (num_windows - 1)
    hi = (r - 1) >> s
    p_max = max(min(r, (b + 1) << s) - (b << s) for b in range(hi + 1)) / r
    # +1: the signed recoding's carry out of window W-2
    return hi + 1, p_max


def _load_cap(lam: float) -> int:
    """Bucket capacity for mean load lam: six sigmas of slack, in 8s."""
    return int(np.ceil((lam + 6 * np.sqrt(lam) + 8) / 8.0)) * 8


def _top_fold_shape(n_j: int, c: int, num_windows: int) -> tuple:
    """(nb_top, cap_top) for the top-window fold of an n_j-point job."""
    max_digit, p_max = _top_digit_pmax(c, num_windows)
    return max_digit + 1, _load_cap(max(1.0, n_j * p_max))


def _merged_cap(n_j: int, c: int, num_windows: int) -> int:
    """Capacity of the merged window (windows 0..W-2) for n_j points."""
    nb = (1 << (c - 1)) + 1
    return _load_cap(max(1, (n_j * (num_windows - 1)) // (nb - 1)))


# --------------------------------------------------------------------------
# group sums


def _hillis_scan_add(pts: cd.Point, reverse: bool) -> cd.Point:
    """Inclusive point-add scan along axis 0 (Hillis-Steele, log n adds):
    row i takes row i + 2^k (reverse) or i - 2^k, as msm.py:45 does."""
    n = pts[0].shape[0]
    for k in range(max((n - 1).bit_length(), 1)):
        off = 1 << k
        if off >= n:
            break
        if reverse:
            head = cd.add(tuple(p[: n - off] for p in pts), tuple(p[off:] for p in pts))
            pts = tuple(torch.cat([h, p[n - off :]]) for h, p in zip(head, pts))
        else:
            tail = cd.add(tuple(p[off:] for p in pts), tuple(p[: n - off] for p in pts))
            pts = tuple(torch.cat([p[:off], t]) for t, p in zip(tail, pts))
    return pts


def _windows_kernel(xy: torch.Tensor, layouts: torch.Tensor, exact: bool):
    """Σ_b b·S_b of J windows at once (msm.py:68-127): the bucket sums S_b
    of kernel 5 over lane-major layouts [J, nb, cap] into the packed rows
    `xy`, then two scans.  A window is a job's merged window on the table
    path and one radix-2^c window on the classic path.  -> ([J] totals,
    flag count)."""
    J, nb, cap = layouts.shape
    buckets, flag = curve.bucket_fold(xy, layouts.reshape(J * nb, cap), exact)
    ident = cd.identity((1, J), xy.device)
    # [nb, J]: bucket index leads so the scans run along axis 0; digit 0 adds nothing
    buckets = tuple(
        torch.cat([ident[i], b.reshape(J, nb, -1).transpose(0, 1)[1:]]) for i, b in enumerate(buckets)
    )
    suffix = _hillis_scan_add(buckets, reverse=True)  # S'_j = Σ_{b >= j} S_b
    suffix = tuple(torch.cat([ident[i], s[1:]]) for i, s in enumerate(suffix))
    totals = _hillis_scan_add(suffix, reverse=False)
    return tuple(t[-1] for t in totals), flag


# --------------------------------------------------------------------------
# the classic Pippenger


def _bucket_counts(d: torch.Tensor, nb: int) -> torch.Tensor:
    """[rows, n] digits -> [rows, nb] int64 entries per bucket (bincount per row)."""
    counts = torch.zeros((d.shape[0], nb), dtype=torch.int64, device=d.device)
    return counts.scatter_add_(1, d, torch.ones_like(d))


def _window_layout_device(d: torch.Tensor, nb: int, cap: int):
    """Bucket layouts of unsigned-digit windows, computed on the device
    (msm.py:321): [rows, n] int64 digits -> (lane-major layouts
    [rows, nb, cap] int32 — slot j of bucket b holds k + 1 for the j-th
    point k with digit b in index order, 0 = empty — and the spill count).

    The JAX package's layout is slot-major with -1 for empty: the same
    entries.  Digit 0 fills no bucket; entries past `cap` are left out and
    counted in the spill."""
    rows, n = d.shape
    dev = d.device
    d_sorted, order = torch.sort(d, dim=1, stable=True)
    counts = _bucket_counts(d, nb)
    starts = counts.cumsum(1) - counts
    col = torch.arange(n, device=dev) - torch.gather(starts, 1, d_sorted)
    keep = d_sorted != 0
    valid = keep & (col < cap)
    spill = (keep & ~valid).sum()
    row = torch.arange(rows, device=dev)[:, None]
    dump = rows * nb * cap  # one slot past the layouts takes the left-out entries
    pos = torch.where(valid, (row * nb + d_sorted) * cap + col, dump)
    layout = torch.zeros(dump + 1, dtype=torch.int32, device=dev)
    layout.scatter_(0, pos.reshape(-1), (order + 1).to(torch.int32).reshape(-1))
    return layout[:dump].reshape(rows, nb, cap), spill


def _classic_top_shape(n: int, c: int, num_windows: int) -> tuple:
    """(nb_top, cap_top) of the unsigned top window (msm.py:363): bucket
    count from the modulus's high bits, capacity from the load model."""
    # the table path's largest signed top digit, hi + 1, is the unsigned bucket count
    nb_top, p_max = _top_digit_pmax(c, num_windows)
    return nb_top, _load_cap(max(1.0, n * p_max))


def _classic_shape(n: int, c: int) -> tuple:
    """(num_windows, nb, cap) of the classic Pippenger: the capacity is
    about twice the mean bucket load, in powers of two."""
    nb = 1 << c
    return -(-FR_BITS // c), nb, 1 << max(3, (2 * max(1, n // nb) - 1).bit_length())


def _window_digits(points: cd.Point, scal16: torch.Tensor, c: int, windows) -> torch.Tensor:
    """[len(windows), n] unsigned digits; identity points get digit 0, so
    they fill no bucket (the fold implies Z = 1 for every filled slot)."""
    ident = cd.is_identity(points)
    return torch.where(ident, 0, _digit_rows(scal16, c, windows))


# windows of one fold launch: at most this many bucket slots
_CLASSIC_MAX_SLOTS = 1 << 21
# columns of one batch of masked sums: at most this many gathered points
_MASKED_MAX_POINTS = 1 << 22


def _fold_windows(xy: torch.Tensor, layouts: torch.Tensor, exact: bool) -> list:
    """Window sums of [G, nb, cap] layouts, in launches of at most
    `_CLASSIC_MAX_SLOTS` slots -> ([G] list of [1] points, [flag counts])."""
    G, nb, cap = layouts.shape
    group = max(1, min(G, _CLASSIC_MAX_SLOTS // (nb * cap)))
    sums, flags = [], []
    for start in range(0, G, group):
        totals, flag = _windows_kernel(xy, layouts[start : start + group], exact)
        flags.append(flag)
        sums.extend(tuple(t[j : j + 1] for t in totals) for j in range(totals[0].shape[0]))
    return sums, flags


def _masked_digit_sums(points: cd.Point, d: torch.Tensor, cols: list) -> cd.Point:
    """Σ of the points whose digit in row w of d is v, for each column
    (w, v) -> [len(cols)] sums: one masked tree reduction, batched over the
    columns (msm.py:167 reduces one value per call)."""
    n = points[0].shape[0]
    rows = torch.as_tensor([w for w, _ in cols], device=d.device)
    vals = torch.as_tensor([v for _, v in cols], device=d.device)
    mask = (d[rows] == vals[:, None]).T  # [n, C]
    ident = cd.identity((1, 1), points[0].device)
    sel = cd.select_point(mask, tuple(p[:, None] for p in points), ident)
    return tuple(t[0] for t in cd.tree_reduce_add(sel))


def _scale_by_values(parts: cd.Point, values: list) -> cd.Point:
    """[C] points times their small values (< 2^16), by one batched
    double-and-add from the top bit down (msm.py:187-192 per value)."""
    limbs = torch.zeros((len(values), fr.L), dtype=torch.int32, device=parts[0].device)
    limbs[:, 0] = torch.as_tensor(values, device=limbs.device)
    return cd.scalar_mul_batch(parts, limbs, max(values).bit_length())


def _skewed_windows(points: cd.Point, d: torch.Tensor, counts: np.ndarray, rows: list) -> list:
    """Windows whose digits take few distinct values (the narrow top window,
    repeated scalars; msm.py:174-193): per (window, value) the masked sum of
    its points, scaled by the value, then the window's values added up.
    counts: the host's [W, nb] bucket counts.  -> [len(rows)] [1] points."""
    cols = [(w, int(v)) for w in rows for v in np.flatnonzero(counts[w][1:]) + 1]
    n = points[0].shape[0]
    step = max(1, _MASKED_MAX_POINTS // max(n, 1))
    scaled = []
    for start in range(0, len(cols), step):
        chunk = cols[start : start + step]
        parts = _masked_digit_sums(points, d, chunk)
        scaled.append(_scale_by_values(parts, [v for _, v in chunk]))
    scaled = tuple(torch.cat([s[i] for s in scaled]) for i in range(3))
    # [values of the widest window, windows], identity-padded, summed along axis 0
    per = [[j for j, (w, _) in enumerate(cols) if w == r] for r in rows]
    depth = max(len(p) for p in per)
    pad = len(cols)
    grid = torch.as_tensor([p + [pad] * (depth - len(p)) for p in per], device=d.device).T
    ident = cd.identity((1,), points[0].device)
    padded = tuple(torch.cat([s, i]) for s, i in zip(scaled, ident))
    sums = cd.tree_reduce_add(tuple(t[grid] for t in padded))
    return [tuple(t[0, j : j + 1] for t in sums) for j in range(len(rows))]


def msm_pippenger(
    points: cd.Point, scalars_mont: torch.Tensor, c: int | None = None, exact: bool = False
) -> cd.Point:
    """Classic windowed-bucket MSM (msm.py:219-302) -> [1] Jacobian point.

    points: [n] Jacobian batch; scalars_mont: [n, 16] Fr Montgomery limbs.
    One copy to the host per call carries every window's bucket counts (and
    whether any point is off affine form, which one normalization then
    fixes); windows whose largest bucket exceeds `cap` take
    `_skewed_windows`, the rest fold on the device.  With exact=False the
    fold's flags queue in `_FOLD_FLAGS`."""
    n = points[0].shape[0]
    if c is None:
        # a mean bucket load of about 32-64 keeps a 2x capacity bound safe
        c = min(13, max(6, n.bit_length() - 6))
    num_windows, nb, cap = _classic_shape(n, c)
    scal16 = bi.from_mont(fr.CTX, scalars_mont)
    d = _window_digits(points, scal16, c, range(num_windows))
    one = fq.CTX.const("one", points[2].device)
    off_affine = ~((points[2] == one).all(-1) | cd.is_identity(points))
    host = torch.cat([_bucket_counts(d, nb).reshape(-1), off_affine.any().reshape(1).to(torch.int64)]).cpu()
    counts = host[:-1].reshape(num_windows, nb).numpy()
    skewed = [w for w in range(num_windows) if counts[w, 1:].max(initial=0) > cap]
    normal = [w for w in range(num_windows) if w not in skewed]

    windows = [None] * num_windows
    if normal:
        aff = cd.normalize_batch(points) if bool(host[-1]) else points
        layouts, _ = _window_layout_device(d[normal], nb, cap)  # no spill: skewed went apart
        sums, flags = _fold_windows(curve.pack_points_xy(aff[0], aff[1]), layouts, exact)
        if not exact:
            _FOLD_FLAGS.extend(flags)
        for w, pt in zip(normal, sums):
            windows[w] = pt
    if skewed:
        for w, pt in zip(skewed, _skewed_windows(points, d, counts, skewed)):
            windows[w] = pt
    stacked = tuple(torch.stack([w[i] for w in windows]) for i in range(3))
    return curve.combine_windows(stacked, c)


def pippenger_device(points: cd.Point, scal16: torch.Tensor, c: int):
    """The classic Pippenger with no copy to the host (msm.py:445-492): all
    the windows as one block (`pippenger_device_window_block`), combined by
    kernel 6.

    points: [n] batch in affine form (Z in {0, 1}); scal16: canonical
    [n, 16] limbs.  -> ([1] point, 0-d count of spilled entries and flagged
    lanes): the caller reruns on an exact path when the count is not 0."""
    num_windows = _classic_shape(points[0].shape[0], c)[0]
    stacked, spill = pippenger_device_window_block(points, scal16, c, num_windows, 0)
    return curve.combine_windows(stacked, c), spill


def pippenger_device_window_block(points: cd.Point, scal16: torch.Tensor, c: int, wpd: int, w0: int):
    """Window sums T_w of the `wpd` windows from `w0` over ALL the points
    (msm.py:380): the window-sharded distributed MSM gives each device a
    block of windows instead of a shard of points, so every window's bucket
    statistics are the single-device ones however small n/D is;
    `pippenger_device` takes every window as one block.

    points: [n] batch in affine form; scal16: canonical [n, 16] limbs.
    -> ((X, Y, Z) of [wpd, 1, L], 0-d count of spilled entries and flagged
    lanes).  Windows past the last one are the identity; the top window
    folds apart with its own narrow bucket space (`_classic_top_shape`)."""
    n = points[0].shape[0]
    num_windows, nb, cap = _classic_shape(n, c)
    top = num_windows - 1
    own = range(w0, min(w0 + wpd, num_windows))
    xy = curve.pack_points_xy(points[0], points[1])
    spill = torch.zeros((), dtype=torch.int64, device=points[0].device)
    sums = {}
    groups = [([w for w in own if w != top], nb, cap)]
    if top in own:
        groups.append(([top], *_classic_top_shape(n, c, num_windows)))
    for ws, nbw, capw in groups:
        if not ws:
            continue
        layouts, s = _window_layout_device(_window_digits(points, scal16, c, ws), nbw, capw)
        folded, flags = _fold_windows(xy, layouts, exact=False)
        spill = spill + s + sum(f.to(spill.dtype) for f in flags)
        sums.update(zip(ws, folded))
    ident = cd.identity((1,), points[0].device)
    windows = [sums.get(w, ident) for w in range(w0, w0 + wpd)]
    return tuple(torch.stack([w[i] for w in windows]) for i in range(3)), spill


def _job_digits(table: FixedBaseTable, scal16: torch.Tensor, offsets: list):
    """Bucket indices and ±encoded table rows of J equal-size jobs.

    scal16: [J, n, 16] canonical scalars.  -> (merged bucket [J, W-1, n],
    merged encodings, top-window digits [J, 1, n], top encodings)."""
    c, W, N = table.c, table.num_windows, table.n_base
    J, n_j, _ = scal16.shape
    dev = scal16.device
    d = _signed_digits(scal16, c, W).transpose(0, 1)  # [J, W, n]
    body, top = d[:, : W - 1], d[:, W - 1 :]
    first = torch.as_tensor(offsets, dtype=torch.int32, device=dev)[:, None, None] + 1
    idx = torch.arange(n_j, dtype=torch.int32, device=dev)[None, None, :]
    tbl = torch.arange(W - 1, dtype=torch.int32, device=dev)[None, :, None] * N + first + idx
    enc = torch.where(body < 0, -tbl, tbl)
    # the top window's digits are never negative (raw <= 2^tb < 2^(c-1))
    top_enc = ((W - 1) * N + first + idx).expand(J, 1, n_j)
    return body.abs(), enc, top, top_enc


def _window_sums(xy, bucket, enc, nb: int, cap: int, exact: bool):
    """Layouts, fold and scans of one signed window -> ([J] totals, flags).
    With exact=True the capacity rises to the largest bucket found."""
    e_sorted, starts, counts = _sort_buckets(bucket, enc, nb)
    if exact:
        most = int(counts[:, :, 1:].sum(1).max())
        cap = max(cap, -(-most // 8) * 8)
    layouts, spill = _stitch_layouts(e_sorted, starts, counts, cap)
    totals, flag = _windows_kernel(xy, layouts, exact)
    return totals, flag + spill


def _fixed_group(table: FixedBaseTable, scal_cat: torch.Tensor, offsets: list, cap: int, exact: bool):
    """One group of equal-size jobs (port of `_fixed_group_kernel`, msm.py:841):
    digits -> layouts -> fold -> scans for the merged window and for the top
    window.  -> ([J] totals, flag count)."""
    c, W = table.c, table.num_windows
    J = len(offsets)
    scal16 = bi.from_mont(fr.CTX, scal_cat).reshape(J, -1, fr.L)
    bucket, enc, top, top_enc = _job_digits(table, scal16, offsets)
    totals, flag = _window_sums(table.xy, bucket, enc, (1 << (c - 1)) + 1, cap, exact)
    nb_top, cap_top = _top_fold_shape(scal16.shape[1], c, W)
    top_totals, top_flag = _window_sums(table.xy, top, top_enc, nb_top, cap_top, exact)
    return cd.add(totals, top_totals), flag + top_flag


# job-size quantum of the table path: scalar vectors zero-pad up to the next
# multiple (zero digits fill no bucket), and a trailing <= _TAIL_MAX
# coefficients past a quantum boundary split off into the ladder, so jobs of
# nearly equal length share one group (one fold launch)
_FIXED_QUANT = 4096
_TAIL_MAX = 64
# jobs below this many points take the ladder: their fold would be mostly padding
_LADDER_MAX = 512


def msm_fixed_many(table: FixedBaseTable, jobs: list, exact: bool = False) -> list:
    """All (offset, scalars_mont) MSM jobs of a round over the fixed-base
    table -> list of [1]-batch Jacobian points.  Each group of equal padded
    size is one fold launch (up to 2^25 slots); small jobs and tails share
    one ladder call.  Flags queue in `_FOLD_FLAGS` (module docstring)."""
    c, W = table.c, table.num_windows
    nb = (1 << (c - 1)) + 1
    out = [None] * len(jobs)
    ladder = []  # (job index, offset, scalars, is a tail)
    groups = {}  # padded size -> [(job index, offset, padded scalars)]
    for ji, (off, scal) in enumerate(jobs):
        n_j = scal.shape[0]
        if n_j < _LADDER_MAX:
            ladder.append((ji, off, scal, False))
            continue
        head = (n_j // _FIXED_QUANT) * _FIXED_QUANT
        if head >= _FIXED_QUANT and 0 < n_j - head <= _TAIL_MAX:
            ladder.append((ji, off + head, scal[head:], True))
            scal, n_j = scal[:head], head
        pad = -n_j % _FIXED_QUANT
        if pad:
            scal = torch.nn.functional.pad(scal, (0, 0, 0, pad))
        groups.setdefault(n_j + pad, []).append((ji, off, scal))

    max_slots = 1 << 25
    for n_j, group in sorted(groups.items()):
        cap = _merged_cap(n_j, c, W)
        gsz = max(1, min(len(group), max_slots // (nb * cap)))
        for start in range(0, len(group), gsz):
            chunk = group[start : start + gsz]
            totals, flag = _fixed_group(
                table, torch.cat([s for _, _, s in chunk]), [o for _, o, _ in chunk], cap, exact
            )
            _FOLD_FLAGS.append(flag)
            for j, (ji, _, _) in enumerate(chunk):
                out[ji] = tuple(t[j : j + 1] for t in totals)

    if ladder:
        sums = _shared_ladder(table, [(off, scal) for _, off, scal, _ in ladder])
        for t, (ji, _, _, is_tail) in enumerate(ladder):
            s = tuple(p[t : t + 1] for p in sums)
            out[ji] = cd.add(out[ji], s) if is_tail else s
    return out


def _shared_ladder(table: FixedBaseTable, items: list) -> cd.Point:
    """Σ_i s_i·P_(off+i) of several small (offset, scalars_mont) items -> [T]
    sums, over the table's window rows.

    Each scalar is cut into the fold's balanced signed digits
    (`_signed_digits`, |d| <= 2^(c-1)); its (window w, point i) pair takes
    table row w·N + off + i, the affine 2^(c·w)·P_(off+i), with Y negated
    for a negative digit, and |d| as a c-bit scalar.  One ladder launch runs
    every pair of every item (at most c doublings and c adds a pair), and a
    halving tree of complete adds, one launch a level over all items, joins
    each item's W·n pairs (items padded with zero digits to the longest, the
    pairs with the identity to a power of two).  The JAX package ladders
    these items over 255 bits (msm.py:980-996): the affine sums agree."""
    c, W, N = table.c, table.num_windows, table.n_base
    dev = table.xy.device
    T = len(items)
    longest = max(s.shape[0] for _, s in items)
    scal = torch.stack([torch.nn.functional.pad(s, (0, 0, 0, longest - s.shape[0])) for _, s in items])
    d = _signed_digits(bi.from_mont(fr.CTX, scal), c, W)  # [W, T, longest]; padding: digit 0
    i = torch.arange(longest, device=dev)
    n_t = torch.as_tensor([s.shape[0] for _, s in items], device=dev)
    offs = torch.as_tensor([off for off, _ in items], device=dev)
    # a padded pair's digit is 0 (the identity): any row serves
    pos = torch.where(i < n_t[:, None], offs[:, None] + i, 0)
    rows = torch.arange(W, device=dev)[:, None, None] * N + pos
    x, y = curve.unpack_xy_rows(table.xy[rows.reshape(-1)])
    y = torch.where((d < 0).reshape(-1, 1), fq.neg(y), y)
    mag = torch.zeros((x.shape[0], fr.L), dtype=torch.int32, device=dev)
    mag[:, 0] = d.abs().reshape(-1)
    muls = cd.scalar_mul_batch((x, y, fq.ones((x.shape[0],), dev)), mag, c)
    # [W·longest, T]: an item's pairs along axis 0
    acc = [m.reshape(W, T, longest, -1).transpose(1, 2).reshape(W * longest, T, -1) for m in muls]
    size = 1 << (W * longest - 1).bit_length()
    ident = cd.identity((size - W * longest, T), dev)
    acc = tuple(torch.cat([a, e]) for a, e in zip(acc, ident))
    while size > 1:
        size //= 2
        acc = cd.add(tuple(a[:size] for a in acc), tuple(a[size:] for a in acc))
    return tuple(a[0] for a in acc)


def msm_ladder(points: cd.Point, scalars_mont: torch.Tensor) -> cd.Point:
    """Batched double-and-add, then a tree reduction over axis 0: [n, ...]
    points and [n, ..., 16] scalars -> [1, ...] sums."""
    scal = bi.from_mont(fr.CTX, scalars_mont)
    muls = cd.scalar_mul_batch(points, scal, FR_BITS)
    return cd.tree_reduce_add(muls)
