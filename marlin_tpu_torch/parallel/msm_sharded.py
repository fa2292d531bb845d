"""Distributed MSM over a device mesh.

Port of `marlin_tpu/parallel/msm_sharded.py`.  Bucket accumulation,
bucket combine and the window sum are all linear, so an MSM splits over
devices and the partial results add up.  Three bodies, by the points a
device would hold (n_local = n / D):

* n_local < `ops.msm._PIPPENGER_MIN`: each device ladders its shard of
  points (kernel 4's `scalar_mul`) and tree-reduces it;
* n_local < `WINDOW_BLOCK_MAX`: window sharding — every device holds all
  the points and owns a block of the windows of c = min(13, max(6,
  bit_length(n) - 6)), so each window's bucket statistics are the
  single-device ones however small n/D is.  Each device converts its
  slice of the scalars out of Montgomery form, and the canonical limbs are
  gathered; the window sums are gathered and combined by kernel 6;
* otherwise point sharding: each device runs `ops.msm.pippenger_device`
  (kernels 5 and 6, and kernel 4's scans) on its shard, and the partial
  sums are gathered and tree-reduced.

Each shard's tensors live on its device, and each shard takes the route
of that device, under `on_device` of its own: the kernels on the card,
their plain versions on the CPU.  The partial sums, window sums and
canonical scalars are joined by all-gathers and the spill counts summed
(parallel/collectives.py): moves between devices in one process,
collectives between processes, where each process computes only its own
positions' shards and every process ends with the same result.
The Pippenger bodies count the entries their capped buckets left out and
the lanes whose fast fold met P == Q; `msm_sharded` reruns the exact
single-device `msm_pippenger` when the count is not 0, never the router
of `ops.msm.msm` (which would come back here under an active mesh).
The result lies on the caller's device.
"""

from __future__ import annotations

import torch

from ..fields import active as P
from ..ops import bigint as bi
from ..ops import curve
from ..ops import curve_device as cd
from ..ops import fq, fr
from ..ops import msm as msm_mod
from . import collectives
from .multihost import on_device, shard_devices

FR_BITS = P.FR_BITS

# below this many points a device, shard by window instead of by point
WINDOW_BLOCK_MAX = 1 << 14


def _gather(sh, parts: dict, home) -> cd.Point:
    """The parts ({position: Jacobian batch}, one shape) of every position,
    joined in flat order on `home`: one all-gather."""
    stacked = collectives.all_gather(sh, {k: torch.stack(p) for k, p in parts.items()}, home)
    return tuple(torch.cat([s[i] for s in stacked]) for i in range(3))


def _shards(points: cd.Point, scalars: torch.Tensor, sh) -> dict:
    """Per local position: (its slice of the points, of the scalars), moved
    to its device."""
    n_local = points[0].shape[0] // len(sh.devices)
    out = {}
    for k in sh.local:
        sl = slice(k * n_local, (k + 1) * n_local)
        dev = sh.devices[k]
        out[k] = tuple(c[sl].to(dev) for c in points), scalars[sl].to(dev)
    return out


def _affine(points: cd.Point) -> cd.Point:
    """The points in affine form (Z in {0, 1}), as the Pippenger folds
    take them: one normalization when any point is off it.  Every rank
    holds the same points, so `off.any()` reads the same on every rank."""
    one = fq.CTX.const("one", points[2].device)
    off = ~((points[2] == one).all(-1) | cd.is_identity(points))
    return cd.normalize_batch(points) if bool(off.any()) else points


def msm_sharded_core(points: cd.Point, scalars_mont: torch.Tensor, mesh, axis=None):
    """-> ([1] Jacobian point, 0-d spill count), both on the caller's device.

    The count is always 0 on the ladder body.  `axis` names the data axis
    (a name, a tuple of names flattened into one, or None for all of the
    mesh's axes); n must divide over its devices except on the
    window-sharded body, which replicates the points.  On a mesh spanning
    processes each rank computes its own positions' shards, and the point
    and the count (summed over every rank) are the same on every rank."""
    home = points[0].device
    sh = shard_devices(mesh, axis, home)
    d = len(sh.devices)
    n = points[0].shape[0]
    n_local = n // d
    zero = torch.zeros((), dtype=torch.int64, device=home)

    # n, and so the body, is the same on every rank: the same call on the same inputs
    if n_local < WINDOW_BLOCK_MAX and n_local >= msm_mod._PIPPENGER_MIN:
        points = _affine(points)
        c = min(13, max(6, n.bit_length() - 6))
        num_windows = -(-FR_BITS // c)
        wpd = -(-num_windows // d)
        # each position converts an equal slice of the scalars (zero-padded
        # to a multiple of d), and the canonical limbs are gathered
        padded = torch.nn.functional.pad(scalars_mont, (0, 0, 0, -n % d))
        slices = padded.tensor_split(d)
        canonical = {}
        for k in sh.local:
            dev = sh.devices[k]
            with on_device(dev):
                canonical[k] = bi.from_mont(fr.CTX, slices[k].to(dev))
        canonical = torch.cat(collectives.all_gather(sh, canonical, home))[:n]
        parts, spills = {}, {}
        for k in sh.local:
            dev = sh.devices[k]
            with on_device(dev):
                parts[k], spills[k] = msm_mod.pippenger_device_window_block(
                    tuple(t.to(dev) for t in points), canonical.to(dev), c, wpd, k * wpd
                )
        windows = tuple(t[:num_windows] for t in _gather(sh, parts, home))
        return curve.combine_windows(windows, c), collectives.sum_counts(sh, spills, home)

    if n % d:
        raise ValueError(f"{n} points do not divide over {d} devices")
    if n_local < msm_mod._PIPPENGER_MIN:
        # the shards that share a device ladder in one launch, each shard
        # reduced on its own: the partial sums are the per-shard ones
        parts = {}
        shards = _shards(points, scalars_mont, sh)
        for dev in dict.fromkeys(sh.devices[k] for k in sh.local):
            ks = [k for k in sh.local if sh.devices[k] == dev]
            with on_device(dev):
                pts = tuple(torch.cat([shards[k][0][i] for k in ks]) for i in range(3))
                canonical = bi.from_mont(fr.CTX, torch.cat([shards[k][1] for k in ks]))
                muls = cd.scalar_mul_batch(pts, canonical, FR_BITS)
                sums = cd.tree_reduce_add(tuple(m.reshape(len(ks), n_local, -1).transpose(0, 1) for m in muls))
            for j, k in enumerate(ks):
                parts[k] = tuple(t[0, j : j + 1] for t in sums)
        return cd.tree_reduce_add(_gather(sh, parts, home)), zero

    points = _affine(points)
    c = min(13, max(6, n_local.bit_length() - 6))
    parts, spills = {}, {}
    for k, (pts, s) in _shards(points, scalars_mont, sh).items():
        with on_device(sh.devices[k]):
            parts[k], spills[k] = msm_mod.pippenger_device(pts, bi.from_mont(fr.CTX, s), c)
    return cd.tree_reduce_add(_gather(sh, parts, home)), collectives.sum_counts(sh, spills, home)


def msm_sharded(points: cd.Point, scalars_mont: torch.Tensor, mesh, axis=None) -> cd.Point:
    """Σ_i s_i P_i over the devices of `mesh`'s `axis` -> [1] Jacobian point
    on the caller's device; exact.  A spill reruns the single-device
    `msm_pippenger` with exact=True: it is taken precisely when a bucket
    overflowed or a fast fold degenerated, so the rerun must not take the
    fast fold again.  The count is summed over every rank of a mesh
    spanning processes, so every rank reruns, or none does."""
    pt, spill = msm_sharded_core(points, scalars_mont, mesh, axis)
    if int(spill) != 0:
        return msm_mod.msm_pippenger(points, scalars_mont, exact=True)
    return pt
