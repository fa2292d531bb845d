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
their plain versions on the CPU.
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
from .multihost import on_device, shard_devices

FR_BITS = P.FR_BITS

# below this many points a device, shard by window instead of by point
WINDOW_BLOCK_MAX = 1 << 14


def _gather(parts: list, device) -> cd.Point:
    return tuple(torch.cat([p[i].to(device) for p in parts]) for i in range(3))


def _shards(points: cd.Point, scalars: torch.Tensor, devs: list):
    """Per device: (its slice of the points, of the scalars), moved there."""
    n_local = points[0].shape[0] // len(devs)
    for k, dev in enumerate(devs):
        sl = slice(k * n_local, (k + 1) * n_local)
        yield tuple(c[sl].to(dev) for c in points), scalars[sl].to(dev)


def _affine(points: cd.Point) -> cd.Point:
    """The points in affine form (Z in {0, 1}), as the Pippenger folds
    take them: one normalization when any point is off it."""
    one = fq.CTX.const("one", points[2].device)
    off = ~((points[2] == one).all(-1) | cd.is_identity(points))
    return cd.normalize_batch(points) if bool(off.any()) else points


def msm_sharded_core(points: cd.Point, scalars_mont: torch.Tensor, mesh, axis=None):
    """-> ([1] Jacobian point, 0-d spill count), both on the caller's device.

    The count is always 0 on the ladder body.  `axis` names the data axis
    (a name, a tuple of names flattened into one, or None for all of the
    mesh's axes); n must divide over its devices except on the
    window-sharded body, which replicates the points."""
    home = points[0].device
    devs = shard_devices(mesh, axis, home)
    d = len(devs)
    n = points[0].shape[0]
    n_local = n // d
    zero = torch.zeros((), dtype=torch.int64, device=home)

    if n_local < WINDOW_BLOCK_MAX and n_local >= msm_mod._PIPPENGER_MIN:
        points = _affine(points)
        c = min(13, max(6, n.bit_length() - 6))
        num_windows = -(-FR_BITS // c)
        wpd = -(-num_windows // d)
        canonical = []
        for s, dev in zip(torch.tensor_split(scalars_mont, d), devs):
            with on_device(dev):
                canonical.append(bi.from_mont(fr.CTX, s.to(dev)).to(home))
        canonical = torch.cat(canonical)
        parts, spill = [], zero
        for k, dev in enumerate(devs):
            with on_device(dev):
                stacked, s = msm_mod.pippenger_device_window_block(
                    tuple(t.to(dev) for t in points), canonical.to(dev), c, wpd, k * wpd
                )
            parts.append(stacked)
            spill = spill + s.to(home)
        windows = tuple(t[:num_windows] for t in _gather(parts, home))
        return curve.combine_windows(windows, c), spill

    if n % d:
        raise ValueError(f"{n} points do not divide over {d} devices")
    if n_local < msm_mod._PIPPENGER_MIN:
        # the shards that share a device ladder in one launch, each shard
        # reduced on its own: the partial sums are the per-shard ones
        parts = [None] * d
        shards = list(_shards(points, scalars_mont, devs))
        for dev in dict.fromkeys(devs):
            ks = [k for k in range(d) if devs[k] == dev]
            with on_device(dev):
                pts = tuple(torch.cat([shards[k][0][i] for k in ks]) for i in range(3))
                canonical = bi.from_mont(fr.CTX, torch.cat([shards[k][1] for k in ks]))
                muls = cd.scalar_mul_batch(pts, canonical, FR_BITS)
                sums = cd.tree_reduce_add(tuple(m.reshape(len(ks), n_local, -1).transpose(0, 1) for m in muls))
            for j, k in enumerate(ks):
                parts[k] = tuple(t[0, j : j + 1] for t in sums)
        return cd.tree_reduce_add(_gather(parts, home)), zero

    points = _affine(points)
    c = min(13, max(6, n_local.bit_length() - 6))
    parts, spill = [], zero
    for (pts, s), dev in zip(_shards(points, scalars_mont, devs), devs):
        with on_device(dev):
            part, sp = msm_mod.pippenger_device(pts, bi.from_mont(fr.CTX, s), c)
        parts.append(part)
        spill = spill + sp.to(home)
    return cd.tree_reduce_add(_gather(parts, home)), spill


def msm_sharded(points: cd.Point, scalars_mont: torch.Tensor, mesh, axis=None) -> cd.Point:
    """Σ_i s_i P_i over the devices of `mesh`'s `axis` -> [1] Jacobian point
    on the caller's device; exact.  A spill reruns the single-device
    `msm_pippenger` with exact=True: it is taken precisely when a bucket
    overflowed or a fast fold degenerated, so the rerun must not take the
    fast fold again."""
    pt, spill = msm_sharded_core(points, scalars_mont, mesh, axis)
    if int(spill) != 0:
        return msm_mod.msm_pippenger(points, scalars_mont, exact=True)
    return pt
