"""Distributed NTT: Bailey's four-step over a device mesh.

Port of `marlin_tpu/parallel/ntt_sharded.py`.  Decomposition (n = n1·n2,
n1 = 2^floor(log2(n)/2), ω the size-n root):
    coefficients viewed as A[i1, i2] with flat index i = i1 + n1·i2;
    1. size-n2 NTTs along i2, each device over its block of rows i1;
    2. twiddle A[i1, k2] *= ω^(i1·k2);
    3. transpose: every device sends each other device its block of k2;
    4. size-n1 NTTs along i1, each device over its block of columns k2;
    the result O[k1, k2] is the evaluation at k = k1·n2 + k2 (row-major
    natural order).
Both n1 and n2 must divide by the device count D.

The row and column transforms are the port's radix-2 path (ops/ntt.py:
`_plan(n, inverse)`, kernel 3 on the card, its plain twins on the CPU),
run as one batch per device, each under `on_device` of its own; the
twiddles are kernel-1 Fr products; a transpose is one all-to-all
(parallel/collectives.py): slices moved between the shards' devices in
one process, a collective between processes, where each process
transforms only the rows and columns of its own shards.  An inverse
transform's n^-1 is the two stages' n2^-1 · n1^-1.

The port's prover is not mesh-aware, so both variants end in one
all-gather and return the result on the caller's device, on every rank
(the JAX `ntt_4step` returns it sharded over k2, `ntt_4step_resident`
block-sharded): the limbs are the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import active as P
from ..ops import fr, ntt
from ..ops.limbs import ints_to_limbs
from . import collectives
from .multihost import on_device, shard_devices

R = P.R_MODULUS


@functools.lru_cache(maxsize=None)
def _outer_twiddles(n1: int, n2: int, inverse: bool) -> np.ndarray:
    """[n1, n2, L] Montgomery twiddles ω^(i1·k2) (ω^-1 for an inverse)."""
    from ..snark.domains import Radix2Domain

    dom = Radix2Domain(n1 * n2)
    w = dom.group_gen_inv if inverse else dom.group_gen
    vals = []
    for i1 in range(n1):
        wi = pow(w, i1, R)
        acc = 1
        for _ in range(n2):
            vals.append(acc * P.FR_MONT_R % R)
            acc = acc * wi % R
    return ints_to_limbs(vals, fr.L).reshape(n1, n2, fr.L)


@functools.lru_cache(maxsize=None)
def _twiddle_tensor(n1: int, n2: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_outer_twiddles(n1, n2, inverse).astype(np.int32), device=device)


def split_sizes(n: int, d: int) -> tuple:
    """(n1, n2) of the four-step split of a power of two n over d devices;
    raises unless both divide by d."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"the four-step NTT takes a power of two, not {n}")
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    if n1 % d or n2 % d:
        raise ValueError(f"n1={n1}, n2={n2} do not divide over {d} devices")
    return n1, n2


def _along_rows(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """NTTs along dim 1 of [r, m, L]: one batch of the radix-2 path."""
    return ntt.transform(x.contiguous(), inverse)


def ntt_4step(coeffs: torch.Tensor, mesh, axis=None, inverse: bool = False) -> torch.Tensor:
    """NTT (or inverse NTT) of a [n, L] vector over the devices of `mesh`'s
    `axis` (a name, a tuple of names flattened into one data axis, or None
    for all of the mesh's axes) -> evaluations in natural order on the
    caller's device (on every rank of a mesh spanning processes)."""
    home = coeffs.device
    sh = shard_devices(mesh, axis, home)
    d = len(sh.devices)
    n = coeffs.shape[0]
    n1, n2 = split_sizes(n, d)
    r = n1 // d
    mat = coeffs.reshape(n2, n1, fr.L).transpose(0, 1)  # A[i1, i2]
    rows = {}
    for k in sh.local:
        dev = sh.devices[k]
        with on_device(dev):
            a = _along_rows(mat[k * r : (k + 1) * r].to(dev), inverse)  # B[i1, k2]
            rows[k] = fr.mul(a, _twiddle_tensor(n1, n2, inverse, dev)[k * r : (k + 1) * r])
    cols = {}
    for j, b in collectives.all_to_all(sh, rows).items():  # the transpose: [n1, k2 block j, L]
        with on_device(sh.devices[j]):
            cols[j] = _along_rows(b.transpose(0, 1), inverse).transpose(0, 1)  # O[k1, k2 block]
    return torch.cat(collectives.all_gather(sh, cols, home), dim=1).reshape(n, fr.L)


def ntt_sharded_reference(coeffs: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The single-device transform the sharded ones must equal."""
    return ntt.transform(coeffs, inverse)


# --------------------------------------------------------------------------
# resident variant: flat block shards in, flat block shards out
#
#   flat i = i1 + n1·i2  ->  A[i2, i1] (reshape [n2, n1]); flat blocks are
#   i2 blocks.
#     1. exchange #1: to i1 blocks                    [n2, n1/D]
#     2. size-n2 NTTs along i2                        B[k2, i1]
#     3. twiddle ω^(i1·k2)
#     4. exchange #2: to k2 blocks                    [n2/D, n1]
#     5. size-n1 NTTs along i1                        X[k2, k1]
#     6. exchange #3: to k1 blocks, transposed        [n1/D, n2]
#   output flat k = k1·n2 + k2; flat blocks are k1 blocks.
# Three exchanges of n/D elements a device and no gather between them.


def ntt_4step_resident(coeffs: torch.Tensor, mesh, axis=None, inverse: bool = False) -> torch.Tensor:
    """Four-step NTT of a [n, L] vector whose exchanges keep flat block
    sharding: block k of the input goes to the k-th device of `mesh`'s
    `axis` (the JAX package's `block_sharding` placement).  Returns the
    evaluations in natural order on the caller's device (on every rank of a
    mesh spanning processes: one all-gather of the k1 blocks)."""
    home = coeffs.device
    sh = shard_devices(mesh, axis, home)
    d = len(sh.devices)
    n = coeffs.shape[0]
    n1, n2 = split_sizes(n, d)
    r1, r2 = n1 // d, n2 // d
    chunks = torch.chunk(coeffs, d)
    blocks = {k: chunks[k].to(sh.devices[k]).reshape(r2, n1, fr.L) for k in sh.local}  # A[i2 block, i1]
    # 1-3: complete i2 on each i1 block, NTTs along i2, twiddle
    stage = {}
    for j, a in collectives.all_to_all(sh, blocks).items():  # [n2, r1, L]
        dev = sh.devices[j]
        with on_device(dev):
            a = _along_rows(a.transpose(0, 1), inverse)  # B[i1 block, k2]
            stage[j] = fr.mul(a, _twiddle_tensor(n1, n2, inverse, dev)[j * r1 : (j + 1) * r1])
    # 4-5: complete i1 on each k2 block, NTTs along i1
    stage2 = {}
    for j, a in collectives.all_to_all(sh, stage).items():  # [n1, r2, L]
        with on_device(sh.devices[j]):
            stage2[j] = _along_rows(a.transpose(0, 1), inverse)  # X[k2 block, k1]
    # 6: to k1 blocks: output block j holds rows k1 of block j, all k2
    out = {j: x.transpose(0, 1) for j, x in collectives.all_to_all(sh, stage2).items()}  # [r1, n2, L]
    return torch.cat(collectives.all_gather(sh, out, home)).reshape(n, fr.L)
