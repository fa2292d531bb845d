"""Mesh context: opt-in multi-device execution for the whole prove path.

Port of `marlin_tpu/parallel/context.py`.  Inside `use_mesh(mesh)` the hot
entry points — `ops.ntt.ntt/intt/ntt_many/intt_many` and
`ops.msm.msm/msm_many` — route operands of at least `NTT_MIN_SHARDED` /
`MSM_MIN_SHARDED` elements that divide over the mesh to the four-step NTT
(parallel/ntt_sharded.py) and the distributed Pippenger
(parallel/msm_sharded.py).  Protocol code is untouched: the same
`Marlin.prove` runs on one device or over a mesh (`mesh=`), with the same
proof bytes.  A sharded result comes back to the caller's device.  On a
mesh spanning processes every rank runs the same prove: the routers'
size checks read shapes, which are the same on every rank, so every rank
takes the same route and joins the same collectives.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

from .multihost import Mesh, axis_devices, require_group

# route only sizes where the exchanges between shards can pay off
NTT_MIN_SHARDED = 1 << 12
MSM_MIN_SHARDED = 1 << 12


@dataclass(frozen=True)
class ParallelContext:
    mesh: Mesh
    # a single mesh-axis name, a tuple of names treated as one flattened
    # data axis (the (dcn, ici) two-level topology — parallel/multihost.py),
    # or None for all of the mesh's axes
    axis: str | tuple | None = None

    @property
    def devices(self) -> list:
        return axis_devices(self.mesh, self.axis)

    @property
    def num_devices(self) -> int:
        return len(self.devices)


_current: ParallelContext | None = None


def current() -> ParallelContext | None:
    return _current


@contextmanager
def use_mesh(mesh: Mesh, axis: str | tuple | None = None):
    """Run the enclosed block with sharded NTT/MSM over `mesh`'s `axis`
    (default: all of its axes, flattened; the JAX package's default is the
    axis "x" of its one-axis test meshes).  A mesh spanning processes needs
    their group (`multihost.init_distributed`)."""
    global _current
    axis_devices(mesh, axis)  # the axis must exist
    require_group(mesh)
    prev = _current
    _current = ParallelContext(mesh, axis)
    try:
        yield _current
    finally:
        _current = prev
