"""The (dcn, ici) device mesh of one process.

Port of `marlin_tpu/parallel/multihost.py`.  The JAX layer is
single-controller SPMD: `shard_map` runs one program per device of a
`jax.sharding.Mesh`.  Here a mesh is a named grid of `torch.device`s held
by one process, and the sharded ops (`ntt_sharded.py`, `msm_sharded.py`)
loop over its devices: each shard's tensors live on its own device, and a
collective is an explicit move of tensor slices between devices.  A
device may repeat — `[cpu] * 8` in the tests, `[cuda:0] * 4` on one card
— and then the moves are copies on that device, or nothing.  The CUDA
wrappers launch on the current device (ops/cuda.py), so each shard's work
runs under `on_device` of its card.

The two axes are the JAX package's: a slow DCN axis across hosts and a
fast ICI axis within one.  The data-parallel kernels treat a tuple of axes
as one flattened data axis, row-major over the tuple.  A mesh spanning
processes (`init_distributed`) is not ported: it needs the sharded ops'
collectives over `torch.distributed`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

DCN_AXIS = "dcn"
ICI_AXIS = "ici"
DATA_AXES = (DCN_AXIS, ICI_AXIS)


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices with one name per axis (the `jax.sharding.Mesh`
    counterpart): `devices` is an object array of `torch.device`s whose
    dimensions are the named axes, in order."""

    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        devs = np.vectorize(torch.device, otypes=[object])(np.asarray(self.devices, dtype=object))
        names = (self.axis_names,) if isinstance(self.axis_names, str) else tuple(self.axis_names)
        if devs.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {devs.shape} cannot take the axis names {names}")
        if devs.size == 0:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict:
        """Axis name -> extent."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(num_hosts: int | None = None, devices=None) -> Mesh:
    """(dcn, ici) mesh over `devices`, by default every visible CUDA device.

    `num_hosts` sets the DCN extent (it must divide the device count); by
    default it is 1, the one process this package runs in, so the whole
    mesh is one ICI slice."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices=, e.g. [torch.device('cpu')] * 8"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    devs = np.empty(len(devices), dtype=object)
    devs[:] = list(devices)
    hosts = 1 if num_hosts is None else num_hosts
    if hosts < 1 or devs.size % hosts:
        raise ValueError(f"{devs.size} devices do not split over {hosts} hosts")
    return Mesh(devs.reshape(hosts, devs.size // hosts), DATA_AXES)


def _axes(mesh: Mesh, axis) -> tuple:
    if axis is None:
        return mesh.axis_names
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def axis_size(mesh: Mesh, axis) -> int:
    """Extent of a (possibly tuple) mesh axis; None is all of the mesh."""
    out = 1
    for a in _axes(mesh, axis):
        out *= mesh.shape[a]
    return out


def axis_flat_index(mesh: Mesh, axis, coords: dict) -> int:
    """Flattened index along a (possibly tuple) data axis of the device at
    `coords` (axis name -> position), row-major over the tuple's axes — the
    order in which a tuple axis shards an array."""
    idx = 0
    for a in _axes(mesh, axis):
        idx = idx * mesh.shape[a] + coords[a]
    return idx


def axis_devices(mesh: Mesh, axis) -> list:
    """The devices along a (possibly tuple) data axis, by flat index (None:
    all of the mesh's axes).  The mesh's other axes hold replicas; their
    first position serves."""
    axes = _axes(mesh, axis)
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"the mesh has no axis {missing[0]!r} (axes {mesh.axis_names})")
    out = [None] * axis_size(mesh, axes)
    for pos in np.ndindex(mesh.devices.shape):
        coords = dict(zip(mesh.axis_names, pos))
        if all(coords[a] == 0 for a in mesh.axis_names if a not in axes):
            out[axis_flat_index(mesh, axes, coords)] = mesh.devices[pos]
    return out


def require_device_type(devices, home: torch.device, what: str) -> None:
    """Refuse a mesh with a device of another type than `home`'s: the shards
    would move the caller's work to that device type (a card's to the CPU's
    plain versions, or the reverse)."""
    devs = list(devices)
    if any(d.type != home.type for d in devs):
        raise ValueError(f"a mesh of {[str(d) for d in devs]} for {what} on {home}")


def on_device(dev: torch.device):
    """The context a shard's work runs in: `dev` as the current CUDA device,
    where the wrappers launch; nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def shard_devices(mesh: Mesh, axis, home: torch.device) -> list:
    """`axis_devices` for operands on `home`, refusing a mesh of another
    device type (`require_device_type`)."""
    devs = axis_devices(mesh, axis)
    require_device_type(devs, home, "operands")
    return devs
