"""The exchanges between the shards of a mesh.

The only calls into `torch.distributed` of the sharded ops.  They stand
where the JAX package's `shard_map` bodies call XLA's collectives
(`all_to_all`, `all_gather`, `psum`).  Each takes the `Shards` of the data
axis (parallel/multihost.py) and the parts of the positions this process
computes, by flat position:

* `all_to_all`: each part splits into equal blocks, one for every
  position; each position receives its block of every part, in flat
  order (the four-step NTT's transposes);
* `all_gather`: every part, in flat order, on the caller's device (the
  partial sums, the window sums, the canonical scalars, the NTT's
  result);
* `sum_counts`: the sum of a 0-d int64 count over the positions (the
  Pippenger bodies' spill count).

Within one process an exchange moves slices between the shards' devices
(`.to(dev)`).  Across processes each rank first joins its parts on its
first device, then runs one collective over the group: on the card under
NCCL; under gloo, card tensors cross through host memory and back
("gloo-host"), CPU tensors directly ("gloo").  `EXCHANGES` counts the
collectives and the bytes each rank sent into them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import multihost

# collectives run by this process, by kind, and the bytes it passed in
EXCHANGES = {"all_to_all": 0, "all_gather": 0, "all_reduce": 0, "bytes": 0}


def reset_exchanges() -> None:
    for k in EXCHANGES:
        EXCHANGES[k] = 0


def route(t: torch.Tensor) -> str:
    """How a collective moves `t`: "nccl", "gloo" (CPU tensors) or
    "gloo-host" (card tensors through host memory)."""
    if multihost.backend() == "nccl":
        return "nccl"
    return "gloo-host" if t.is_cuda else "gloo"


def _run(kind: str, t: torch.Tensor, fn) -> torch.Tensor:
    """`fn(x)` -> the collective's output for input `x`, where x is `t` on
    the device the backend exchanges on; the output comes back to t's
    device."""
    EXCHANGES[kind] += 1
    EXCHANGES["bytes"] += t.numel() * t.element_size()
    if multihost.backend() == "nccl":
        xdev = multihost.group_devices()[0]
    else:
        xdev = torch.device("cpu")
    return fn(t.to(xdev).contiguous()).to(t.device)


def _joined(sh, parts: dict) -> torch.Tensor:
    """This process's parts stacked in flat order on its first device."""
    first = sh.devices[sh.local[0]]
    return torch.stack([parts[k].to(first) for k in sh.local])


def all_to_all(sh, parts: dict, dim: int = 1) -> dict:
    """{k: part} of the local positions, each part split along `dim` into
    D equal blocks (block j for position j) -> {j: the D blocks for j,
    joined along dim 0 in flat order, on j's device} for the local
    positions j."""
    d = len(sh.devices)
    if not sh.spans:
        out = {}
        for j in sh.local:
            dev = sh.devices[j]
            out[j] = torch.cat([p.tensor_split(d, dim)[j].to(dev) for p in (parts[k] for k in range(d))])
        return out
    w = dist.get_world_size()
    dl = d // w
    joined = _joined(sh, parts).flatten(0, 1)  # [dl·rows, .., d·b, ..]
    send = torch.stack(joined.tensor_split(w, dim))  # [w, dl·rows, .., dl·b, ..]: rank q's columns at q

    def exchange(x):
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out

    full = _run("all_to_all", send, exchange).flatten(0, 1)  # every rank's rows, this rank's columns
    return {j: block.to(sh.devices[j]) for j, block in zip(sh.local, full.tensor_split(dl, dim))}


def all_gather(sh, parts: dict, home: torch.device) -> list:
    """{k: part} of the local positions, parts of one shape -> the D parts
    in flat order, on `home`."""
    d = len(sh.devices)
    if not sh.spans:
        return [parts[k].to(home) for k in range(d)]
    w = dist.get_world_size()

    def gather(x):
        outs = [torch.empty_like(x) for _ in range(w)]
        dist.all_gather(outs, x)
        return torch.cat(outs)

    return list(_run("all_gather", _joined(sh, parts), gather).to(home).unbind(0))


def sum_counts(sh, counts: dict, home: torch.device) -> torch.Tensor:
    """{k: 0-d int64 count} of the local positions -> their sum over every
    position, on `home`."""
    total = torch.zeros((), dtype=torch.int64, device=home)
    for k in sh.local:
        total = total + counts[k].to(home)
    if not sh.spans:
        return total

    def reduce(x):
        dist.all_reduce(x)
        return x

    return _run("all_reduce", total, reduce)
