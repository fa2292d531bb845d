"""Carry state over from the JAX package: the SRS and the index keys.

`to_plain` turns an object graph of keys into plain data — dataclasses into
dicts of their fields, arrays into numpy arrays, ints, tuples and lists as
they are — using nothing but attribute access, so it works on objects of
either package and needs no import of `marlin_tpu` (the JAX package's own
process can call it and pickle the result).  `universal_params`,
`index_keys` and `index` rebuild this package's objects from such plain
data, with the limb arrays as int32 tensors on the requested device.
`index` rebuilds the AHP's `Index` alone, which is all a field with no
curve (`test_wide750`) has: this module imports the PC layer (`ops.fq`,
`snark.kzg`, `snark.sonic`) only inside the functions that need it, so it
loads under such a field.

Limb arrays keep their layout (`[n, L]` 16-bit Montgomery limbs), so the
state crosses over unchanged: proving from it gives the same proof bytes.
Keys of either PC scheme cross: a Sonic verifier key is told apart by its
`neg_h_powers`, and a Sonic SRS carries its negative G2 powers.  Both
packages must run the same curve (`MARLIN_TPU_CURVE`); an SRS whose Fq
width is not the active curve's is refused.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.sparse import CooMatrix
from .snark.constraint_systems import MatrixArithmetization, MatrixEvals
from .snark.domains import domain_of_size
from .snark.indexer import Index, IndexInfo


def to_plain(obj):
    """Keys/SRS object graph -> dicts, lists, tuples, ints and numpy arrays."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_plain(v) for v in obj)
    if obj is None or isinstance(obj, (int, str, bytes, bool)):
        return obj
    if hasattr(obj, "__array__"):
        return np.asarray(obj)
    raise TypeError(f"to_plain: cannot convert {type(obj).__name__}")


def _limbs(arr, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(np.asarray(arr), dtype=np.int32), device=device)


def _index(arr, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr, dtype=np.int64), device=device)


def _point(p, device):
    return tuple(_limbs(c, device) for c in p)


def _affine(p):
    """Affine G1 (x, y) / G2 ((x0, x1), (y0, y1)) tuples with Python ints."""
    if p is None:
        return None
    return tuple(_affine(c) if isinstance(c, (tuple, list)) else int(c) for c in p)


def universal_params(d: dict, device) -> "kzg.UniversalParams":
    """SRS from plain data (the fields of `kzg.UniversalParams`) of the
    active curve: its G1 powers must have the curve's Fq width (fq.L limbs:
    24, or 16 for BN254); G2 points are pairs over the curve's Fq2."""
    from .ops import fq
    from .snark import kzg

    device = torch.device(device)
    width = np.asarray(d["powers_of_g"][0]).shape[-1]
    if width != fq.L:
        raise ValueError(f"an SRS of {width}-limb Fq, but the active curve's Fq has {fq.L} limbs")
    host_gamma = d.get("host_gamma_powers")
    neg_h = d.get("neg_powers_of_h")
    return kzg.UniversalParams(
        powers_of_g=_point(d["powers_of_g"], device),
        powers_of_gamma_g=_point(d["powers_of_gamma_g"], device),
        g=_affine(d["g"]),
        gamma_g=_affine(d["gamma_g"]),
        h=_affine(d["h"]),
        beta_h=_affine(d["beta_h"]),
        host_gamma_powers=None if host_gamma is None else [_affine(p) for p in host_gamma],
        neg_powers_of_h=None if neg_h is None else [_affine(p) for p in neg_h],
    )


def _commitment(c: dict):
    from .snark import kzg

    return kzg.Commitment(comm=_affine(c["comm"]), shifted_comm=_affine(c["shifted_comm"]))


def _randomness(r: dict):
    from .snark import kzg

    def ints(v):
        return None if v is None else [int(x) for x in v]

    return kzg.Randomness(blind=ints(r["blind"]), shifted_blind=ints(r["shifted_blind"]))


def _coo(m: dict, device) -> CooMatrix:
    reidx = m.get("cols_reindexed")
    return CooMatrix(
        rows=_index(m["rows"], device),
        cols=_index(m["cols"], device),
        vals=_limbs(m["vals"], device),
        num_rows=int(m["num_rows"]),
        num_cols=int(m["num_cols"]),
        cols_reindexed=None if reidx is None else _index(reidx, device),
    )


def _info(d: dict) -> IndexInfo:
    return IndexInfo(**{k: int(v) for k, v in d.items()})


def _pc_verifier_key(vk: dict):
    from .snark import kzg, sonic

    common = dict(
        g=_affine(vk["g"]),
        gamma_g=_affine(vk["gamma_g"]),
        h=_affine(vk["h"]),
        beta_h=_affine(vk["beta_h"]),
        supported_degree=int(vk["supported_degree"]),
        max_degree=int(vk["max_degree"]),
    )
    if "neg_h_powers" in vk:
        neg_h = {int(b): _affine(p) for b, p in vk["neg_h_powers"].items()}
        return sonic.SonicVerifierKey(neg_h_powers=neg_h, **common)
    shift = {int(b): _affine(p) for b, p in vk["shift_powers"].items()}
    return kzg.VerifierKey(shift_powers=shift, **common)


def verifier_key(d: dict):
    """Index verifier key from plain data (host-only: no tensors)."""
    from .snark.data_structures import IndexVerifierKey

    return IndexVerifierKey(
        index_info=_info(d["index_info"]),
        index_comms=[_commitment(c) for c in d["index_comms"]],
        verifier_key=_pc_verifier_key(d["verifier_key"]),
    )


def index(ix: dict, device) -> Index:
    """The AHP's `Index` from plain data (the fields of `indexer.Index`,
    as `to_plain` gives them for either package's index)."""
    device = torch.device(device)
    ja = ix["joint_arith"]
    ev = ja["evals_on_K"]
    return Index(
        index_info=_info(ix["index_info"]),
        a=_coo(ix["a"], device),
        b=_coo(ix["b"], device),
        c=_coo(ix["c"], device),
        joint_arith=MatrixArithmetization(
            **{k: _limbs(ja[k], device) for k in ("row", "col", "val_a", "val_b", "val_c", "row_col")},
            evals_on_K=MatrixEvals(**{k: _limbs(v, device) for k, v in ev.items()}),
        ),
        domain_h=domain_of_size(int(ix["domain_h"]["size"])),
        domain_k=domain_of_size(int(ix["domain_k"]["size"])),
        domain_x=domain_of_size(int(ix["domain_x"]["size"])),
    )


def index_keys(pk: dict, device) -> tuple:
    """(IndexProverKey, IndexVerifierKey) from a plain index prover key; its
    committer key's `pp` may also be a `kzg.UniversalParams` already on
    `device` (an SRS loaded apart, `snark/serial.py`)."""
    from .snark import kzg, sonic
    from .snark.data_structures import IndexProverKey

    device = torch.device(device)
    vk = verifier_key(pk["index_vk"])
    ck = pk["committer_key"]
    is_sonic = isinstance(vk.verifier_key, sonic.SonicVerifierKey)
    key_cls = sonic.SonicCommitterKey if is_sonic else kzg.CommitterKey
    pp = ck["pp"]
    committer_key = key_cls(
        pp=pp if isinstance(pp, kzg.UniversalParams) else universal_params(pp, device),
        supported_degree=int(ck["supported_degree"]),
        degree_bounds=[int(b) for b in ck["degree_bounds"]],
        hiding_bound=int(ck["hiding_bound"]),
    )
    prover_key = IndexProverKey(
        index_vk=vk,
        index_comm_rands=[_randomness(r) for r in pk["index_comm_rands"]],
        index=index(pk["index"], device),
        committer_key=committer_key,
    )
    return prover_key, vk
