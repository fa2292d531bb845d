"""The (dcn, ici) device mesh, in one process or across processes.

Port of `marlin_tpu/parallel/multihost.py`.  The JAX layer is SPMD:
`shard_map` runs one program per device of a `jax.sharding.Mesh`, and
across hosts every process runs the same program on the same inputs
(multi-controller), each on its own devices.  Here a mesh is a named grid
of `torch.device`s, and each position also records the rank of the
process that owns it (`Mesh.ranks`).  The sharded ops (`ntt_sharded.py`,
`msm_sharded.py`) loop over the positions this process owns
(`shard_devices`): each shard's tensors live on its own device, and the
exchanges between shards go through `collectives.py`, as moves of tensor
slices between the devices of one process and as `torch.distributed`
collectives between processes.  A device may repeat — `[cpu] * 8` in the
tests, `[cuda:0] * 4` on one card — and then the moves are copies on that
device, or nothing.  The CUDA wrappers launch on the current device
(ops/cuda.py), so each shard's work runs under `on_device` of its card.

Across processes every process makes the same call with the same inputs,
computes its own shards, and ends with the whole result (the port's
prover is not mesh-aware).  `init_distributed` starts the process group
from torchrun's variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK) or an explicit `init_method`.  Its backend follows a rule on
the device layout (`backend_for`), which every rank reads from the same
exchange of each rank's devices through the rendezvous store:

* every rank holds cards, and no card is held by two ranks: NCCL, each
  rank's first card made current, and the exchanges run on the card;
* otherwise gloo: ranks on the CPU, or a card held by several ranks (NCCL
  refuses two ranks on one card).  Card tensors then cross through host
  memory (`collectives.route` says "gloo-host"); the compute stays on the
  card.

The two axes are the JAX package's: a slow DCN axis across hosts (by
default one position a process) and a fast ICI axis within one.  The
data-parallel kernels treat a tuple of axes as one flattened data axis,
row-major over the tuple.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import socket
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DCN_AXIS = "dcn"
ICI_AXIS = "ici"
DATA_AXES = (DCN_AXIS, ICI_AXIS)

# a rank that dies makes the others raise after at most this long, not hang
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclass(frozen=True)
class _Group:
    rank: int
    world_size: int
    backend: str
    devices: tuple  # this rank's devices


_group: _Group | None = None


def backend_for(layout) -> str:
    """The backend of a layout: [(host name, [device names]) by rank].

    NCCL when every rank holds cards and no card (host, device) is held by
    two ranks; gloo otherwise: ranks on the CPU, or a card shared."""
    cards = [(host, d) for host, devs in layout for d in sorted(set(devs))]
    if all(torch.device(d).type == "cuda" for _, d in cards) and len(cards) == len(set(cards)):
        return "nccl"
    return "gloo"


def _local_devices(devices) -> tuple:
    """This rank's devices: `devices`, or by default its card
    cuda:(LOCAL_RANK mod the card count) where the machine has cards (the
    ranks beyond the card count then share cards, and the layout takes
    gloo), else the CPU."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            return (torch.device("cpu"),)
        return (torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % count),)
    out = tuple(torch.device(d) for d in devices)
    if not out:
        raise ValueError("init_distributed: a rank needs at least one device")
    return tuple(torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d for d in out)


def init_distributed(devices=None, init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None, timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Start the process group of a mesh that spans processes.

    Returns True when a multi-process group was started, and False (doing
    nothing) without a multi-process setting: no `init_method` and no
    MASTER_ADDR (the JAX package: no JAX_COORDINATOR_ADDRESS).  The address
    is torchrun's MASTER_ADDR and MASTER_PORT, or `init_method` (a
    "file://" store or a "tcp://" URL); the rank and world size are
    `rank` and `world_size`, else RANK and WORLD_SIZE.  `devices` are this
    rank's devices (default: its card cuda:LOCAL_RANK, or the CPU on a
    machine without one).  The backend follows `backend_for`; a failed
    init raises.  `timeout` bounds the rendezvous and every collective, so
    a rank that dies makes the others raise."""
    global _group
    if init_method is None:
        if not os.environ.get("MASTER_ADDR"):
            return False
        init_method = "env://"
    if _group is not None or dist.is_initialized():
        raise RuntimeError("init_distributed: the process group is already started")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    devs = _local_devices(devices)
    store, rank, world_size = next(dist.rendezvous(init_method, rank, world_size, timeout=timeout))
    store.set(f"marlin_tpu_torch/layout/{rank}", json.dumps([socket.gethostname(), [str(d) for d in devs]]))
    layout = tuple(tuple(json.loads(store.get(f"marlin_tpu_torch/layout/{r}"))) for r in range(world_size))
    backend = backend_for(layout)
    if backend == "nccl":
        torch.cuda.set_device(devs[0])
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size, timeout=timeout)
    _group = _Group(rank, world_size, backend, devs)
    return True


def rank() -> int:
    """This process's rank (0 without `init_distributed`)."""
    return _group.rank if _group else 0


def world_size() -> int:
    """The number of processes (1 without `init_distributed`)."""
    return _group.world_size if _group else 1


def backend() -> str | None:
    """"nccl" or "gloo" once `init_distributed` has run, else None."""
    return _group.backend if _group else None


def group_devices() -> tuple:
    """This rank's devices as given to `init_distributed`."""
    if _group is None:
        raise RuntimeError("no process group: call init_distributed() first")
    return _group.devices


def shutdown() -> None:
    """Destroy the process group `init_distributed` started (nothing
    without one)."""
    global _group
    if _group is not None:
        _group = None
        dist.destroy_process_group()


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of devices with one name per axis (the `jax.sharding.Mesh`
    counterpart): `devices` is an object array of `torch.device`s whose
    dimensions are the named axes, in order; `ranks` (same shape) holds the
    rank of the process that owns each position, by default this one."""

    devices: np.ndarray
    axis_names: tuple
    ranks: np.ndarray | None = None

    def __post_init__(self):
        devs = np.vectorize(torch.device, otypes=[object])(np.asarray(self.devices, dtype=object))
        names = (self.axis_names,) if isinstance(self.axis_names, str) else tuple(self.axis_names)
        if devs.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {devs.shape} cannot take the axis names {names}")
        if devs.size == 0:
            raise ValueError("a mesh needs at least one device")
        ranks = np.full(devs.shape, rank()) if self.ranks is None else np.asarray(self.ranks, dtype=np.int64)
        if ranks.shape != devs.shape:
            raise ValueError(f"mesh ranks of shape {ranks.shape} for devices of shape {devs.shape}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "ranks", ranks)

    @property
    def shape(self) -> dict:
        """Axis name -> extent."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        return bool((self.ranks != rank()).any())


def make_mesh(num_hosts: int | None = None, devices=None) -> Mesh:
    """(dcn, ici) mesh, `num_hosts` the DCN extent (it must divide the
    device count).

    In one process: over `devices`, by default every visible CUDA device,
    and `num_hosts` defaults to 1, so the whole mesh is one ICI slice.
    Once `init_distributed` has run: `devices` are this rank's (default:
    those it gave `init_distributed`), every rank's are exchanged once
    (`all_gather_object`, so every rank must call), the grid is rank-major
    and `num_hosts` defaults to the world size (JAX: process_count())."""
    if _group is None:
        if devices is None:
            count = torch.cuda.device_count()
            if count == 0:
                raise RuntimeError(
                    "make_mesh: no CUDA device is visible; pass devices=, e.g. [torch.device('cpu')] * 8"
                )
            devices = [torch.device("cuda", i) for i in range(count)]
        flat = list(devices)
        owners = [0] * len(flat)
        hosts = 1 if num_hosts is None else num_hosts
    else:
        local = list(_group.devices) if devices is None else [torch.device(d) for d in devices]
        if not set(local) <= set(_group.devices):
            raise ValueError(f"make_mesh: {[str(d) for d in local]} are not this rank's devices "
                             f"{[str(d) for d in _group.devices]} (init_distributed)")
        gathered = [None] * _group.world_size
        dist.all_gather_object(gathered, [str(d) for d in local])
        if len({len(g) for g in gathered}) != 1:
            raise ValueError(f"make_mesh: the ranks hold unequal device counts {[len(g) for g in gathered]}")
        flat = [torch.device(d) for g in gathered for d in g]
        owners = [r for r, g in enumerate(gathered) for _ in g]
        hosts = _group.world_size if num_hosts is None else num_hosts
    devs = np.empty(len(flat), dtype=object)
    devs[:] = flat
    if hosts < 1 or devs.size % hosts:
        raise ValueError(f"{devs.size} devices do not split over {hosts} hosts")
    shape = (hosts, devs.size // hosts)
    return Mesh(devs.reshape(shape), DATA_AXES, np.asarray(owners).reshape(shape))


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


def _replicas(mesh: Mesh, axis) -> list:
    """Per flat index along a (possibly tuple) data axis, its replicas over
    the mesh's other axes: [(device, owner rank)], the first position's
    first."""
    axes = _axes(mesh, axis)
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"the mesh has no axis {missing[0]!r} (axes {mesh.axis_names})")
    out = [[] for _ in range(axis_size(mesh, axes))]
    for pos in np.ndindex(mesh.devices.shape):
        coords = dict(zip(mesh.axis_names, pos))
        out[axis_flat_index(mesh, axes, coords)].append((mesh.devices[pos], int(mesh.ranks[pos])))
    return out


def axis_devices(mesh: Mesh, axis) -> list:
    """The devices along a (possibly tuple) data axis, by flat index (None:
    all of the mesh's axes).  The mesh's other axes hold replicas; this
    process's first replica serves where it holds one, else the first."""
    me = rank()
    return [next((d for d, r in reps if r == me), reps[0][0]) for reps in _replicas(mesh, axis)]


def require_device_type(devices, home: torch.device, what: str) -> None:
    """Refuse a mesh with a device of another type than `home`'s: the shards
    would move the caller's work to that device type (a card's to the CPU's
    plain versions, or the reverse)."""
    devs = list(devices)
    if any(d.type != home.type for d in devs):
        raise ValueError(f"a mesh of {[str(d) for d in devs]} for {what} on {home}")


def require_group(mesh: Mesh) -> None:
    """Refuse a mesh with positions of other processes unless the process
    group is started and the mesh holds every rank of it: the sharded ops'
    collectives run over the whole group."""
    if not mesh.spans_processes:
        return
    if _group is None:
        raise RuntimeError("a mesh spanning processes needs init_distributed() first")
    if set(np.unique(mesh.ranks).tolist()) != set(range(_group.world_size)):
        raise ValueError(f"a mesh of ranks {sorted(set(mesh.ranks.flat))} in a group of {_group.world_size}")


@dataclass(frozen=True)
class Shards:
    """The positions of a data axis as this process sees them.

    `devices[k]` is position k's device (for another process's position,
    the device that process named), `owners[k]` the rank that computes it.
    Either every position is this process's (`spans` False: the exchanges
    are moves between its devices), or the positions split over the ranks
    in equal runs in rank order (`spans` True: the exchanges are
    collectives)."""

    devices: list
    owners: list
    rank: int
    spans: bool

    @property
    def local(self) -> list:
        """The flat positions this process computes."""
        return [k for k, r in enumerate(self.owners) if r == self.rank]


def shard_devices(mesh: Mesh, axis, home: torch.device) -> Shards:
    """The shards of `mesh`'s `axis` for operands on `home`, refusing a mesh
    of another device type (`require_device_type`), a mesh spanning
    processes without their group (`require_group`), and an axis whose
    positions neither lie whole on every rank (each computes all of them on
    its replicas) nor split over the ranks in equal runs in rank order."""
    require_group(mesh)
    reps = _replicas(mesh, axis)
    devs = axis_devices(mesh, axis)
    require_device_type(devs, home, "operands")
    me = rank()
    holders = [{r for _, r in rs} for rs in reps]
    if all(me in h for h in holders):
        if mesh.spans_processes and any(h != holders[0] for h in holders):
            raise ValueError("a data axis of a mesh spanning processes must lie whole on every rank or split "
                             "over the ranks")
        return Shards(devs, [me] * len(devs), me, False)
    owners = [min(h) for h in holders]
    d, w = len(owners), world_size()
    if any(len(h) != 1 for h in holders) or d % w or owners != [k * w // d for k in range(d)]:
        raise ValueError(f"a data axis over ranks {owners}: a mesh spanning processes must split each data "
                         "axis over the ranks in equal runs in rank order, or hold it whole on every rank")
    return Shards(devs, owners, me, True)


def on_device(dev: torch.device):
    """The context a shard's work runs in: `dev` as the current CUDA device,
    where the wrappers launch; nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
