"""Artifact serialization: SRS, keys, proofs.

Port of `marlin_tpu/snark/serial.py`.  Every long-lived artifact round-trips
(the reference's CanonicalSerialize boundaries, reference
src/data_structures.rs:25-79), so setup -> index -> prove can be split
across processes: the SRS and the index keys through npz archives (limb
arrays and JSON metadata), proofs through the byte codec of
data_structures.py.

The archives are the JAX package's, key for key: uint32 arrays of 16-bit
Montgomery limbs, int32 index arrays, the G2 powers as [n, 24] uint64
rows, the same JSON `meta` (the committer key's `flavor` "kzg"/"sonic",
the verifier key's "marlin"/"sonic").  An archive written by either
package loads in the other.  Torch's CPU uint32 lacks add, shift and
compare, so the limbs cross through numpy into the port's int32 tensors,
and the loaders build the port's objects through `interop.py`.

Decoding validates, as the reference's CanonicalDeserialize does and with
the JAX package's `ValueError`s: the host points of the metadata are in
range and on the curve (index commitments also in the prime-order
subgroup), and the archived G1 powers have every limb below 2^16, Z in
{0, one}, each residue below q and y^2 = x^3 + b.  The JAX package checks
the powers in host Python ints; here the check runs on the load's device
as tensor ops — on the card kernel 1's Fq products and add over the
[n, L] limbs, on the CPU their plain versions — and reads back two flags,
no limb.  Every loader takes `device` (the card unless "cpu"), and a key
loaded onto one device refuses an SRS on another.
"""

from __future__ import annotations

import io
import json
import os

import numpy as np
import torch

from .. import interop
from ..fields import active as P
from ..fields import host_curve as hc
from ..ops import fq
from . import kzg
from .marlin import _same_device, resolve_device

_AXES = "xyz"


# --------------------------------------------------------------------------
# archive <-> numpy


def _u32(t: torch.Tensor) -> np.ndarray:
    """int32 limb tensor -> the archive's uint32 array."""
    return t.detach().cpu().numpy().astype(np.uint32)


def _i32(t: torch.Tensor) -> np.ndarray:
    """int64 index tensor -> the archive's int32 array."""
    return t.detach().cpu().numpy().astype(np.int32)


def _atomic_savez(path: str, **kwargs) -> None:
    buf = io.BytesIO()
    np.savez_compressed(buf, **kwargs)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def _load(path: str) -> tuple:
    """-> (meta dict, {name: array}) of an archive."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"])), {k: z[k] for k in z.files if k != "meta"}


def _g2_list_to_limbs(points: list) -> np.ndarray:
    """G2 affine ((x0,x1),(y0,y1)) tuples -> [n, 24] uint64 LE limb array."""
    out = np.zeros((len(points), 24), dtype=np.uint64)
    for i, ((x0, x1), (y0, y1)) in enumerate(points):
        for j, v in enumerate((x0, x1, y0, y1)):
            for k in range(6):
                out[i, 6 * j + k] = (v >> (64 * k)) & 0xFFFFFFFFFFFFFFFF
    return out


def _limbs_to_g2_list(arr: np.ndarray) -> list:
    out = []
    for row in arr:
        vals = []
        for j in range(4):
            v = 0
            for k in range(6):
                v |= int(row[6 * j + k]) << (64 * k)
            vals.append(v)
        out.append(((vals[0], vals[1]), (vals[2], vals[3])))
    return out


# --------------------------------------------------------------------------
# decode checks


def _require_g1(p, what: str, subgroup: bool = False):
    """Range + on-curve (+ optional subgroup) validation for a decoded G1
    point: a tampered key archive must not be accepted silently."""
    if p is None:
        return None
    q = P.Q_MODULUS
    if not (0 <= p[0] < q and 0 <= p[1] < q):
        raise ValueError(f"{what}: coordinate out of range")
    if not hc.g1_is_on_curve(p):
        raise ValueError(f"{what}: point not on curve")
    if subgroup and not hc.g1_in_subgroup(p):
        raise ValueError(f"{what}: point not in the prime-order subgroup")
    return p


def _require_g2(p, what: str):
    if p is None:
        return None
    q = P.Q_MODULUS
    for pair in p:
        for c in pair:
            if not (0 <= c < q):
                raise ValueError(f"{what}: coordinate out of range")
    if not hc.g2_is_on_curve(p):
        raise ValueError(f"{what}: point not on curve")
    return p


def _at_least_q(t: torch.Tensor) -> torch.Tensor:
    """[.., L] limbs (each below 2^16) -> [..] bool, the value >= q: the sign
    of the highest limb that differs from q's decides, and Σ sign_i·2^i has
    that limb's sign (the lower terms add up to less than its weight)."""
    q = fq.CTX.const("n", t.device).to(torch.int64)
    weights = torch.pow(2, torch.arange(fq.L, device=t.device, dtype=torch.int64))
    return (torch.sign(t.to(torch.int64) - q) * weights).sum(-1) >= 0


_POWER_FAULTS = {1: "non-affine Z in archive", 2: "coordinate residue out of range",
                 3: "off-curve point in archive"}


def _validate_powers_on_curve(pt, what: str) -> None:
    """On-curve check of an archived point batch in affine form (Z in
    {0, one}): y^2 == x^3 + b wherever Z != 0, in Montgomery form on the
    batch's device (kernel 1's Fq products on the card).

    Every limb must be below 2^16: the kernels consume the 32-bit words
    whose Montgomery overflow analysis assumes it, so the check validates
    the representation the kernels see.  A residue at or above q would pass
    the mod-q curve check while the kernels see another representation.
    The first faulty point (by index) names the fault, as in the JAX
    package's loop."""
    if any(c.shape[-1] != fq.L for c in pt):
        raise ValueError(f"{what}: {pt[0].shape[-1]}-limb coordinates, but the active curve's Fq has {fq.L}")
    if bool(torch.stack([((c >> 16) != 0).any() for c in pt]).any()):
        raise ValueError("archive limb out of range (>= 2^16)")
    x, y, z = pt
    if x.shape[0] == 0:
        return
    one = fq.CTX.const("one", z.device)
    lhs = fq.mul(y, y)
    rhs = fq.add(fq.mul(fq.mul(x, x), x), fq.from_int(P.CURVE_B, x.device))
    code = torch.where(
        (z == 0).all(-1), 0,
        torch.where(~(z == one).all(-1), 1,
                    torch.where(_at_least_q(x) | _at_least_q(y), 2, torch.where((lhs != rhs).any(-1), 3, 0))),
    )
    first = int(code[torch.argmax((code != 0).to(torch.int32))])
    if first:
        raise ValueError(f"{what}: {_POWER_FAULTS[first]}")


# --------------------------------------------------------------------------
# SRS


def _srs_meta(pp: kzg.UniversalParams) -> dict:
    return {
        "g": list(pp.g),
        "gamma_g": list(pp.gamma_g),
        "h": [list(pp.h[0]), list(pp.h[1])],
        "beta_h": [list(pp.beta_h[0]), list(pp.beta_h[1])],
        "host_gamma_powers": [list(p) if p else None for p in (pp.host_gamma_powers or [])],
    }


def _srs_arrays(pp: kzg.UniversalParams, prefix: str) -> dict:
    arrays = {}
    for name, pt in (("pg", pp.powers_of_g), ("pgg", pp.powers_of_gamma_g)):
        for axis, c in zip(_AXES, pt):
            arrays[f"{prefix}{name}_{axis}"] = _u32(c)
    if pp.neg_powers_of_h is not None:
        arrays[f"{prefix}neg_h"] = _g2_list_to_limbs(pp.neg_powers_of_h)
    return arrays


def _srs_from(meta: dict, arrays: dict, prefix: str, device: torch.device, what: str) -> kzg.UniversalParams:
    """SRS from its archive parts, validated, with the powers on `device`."""
    neg_h = arrays.get(f"{prefix}neg_h")
    pp = interop.universal_params({
        "powers_of_g": tuple(arrays[f"{prefix}pg_{a}"] for a in _AXES),
        "powers_of_gamma_g": tuple(arrays[f"{prefix}pgg_{a}"] for a in _AXES),
        "g": meta["g"],
        "gamma_g": meta["gamma_g"],
        "h": meta["h"],
        "beta_h": meta["beta_h"],
        "host_gamma_powers": meta["host_gamma_powers"],
        "neg_powers_of_h": None if neg_h is None else _limbs_to_g2_list(neg_h),
    }, device)
    _validate_powers_on_curve(pp.powers_of_g, f"{what}.powers_of_g")
    _validate_powers_on_curve(pp.powers_of_gamma_g, f"{what}.powers_of_gamma_g")
    _require_g1(pp.g, f"{what}.g")
    _require_g1(pp.gamma_g, f"{what}.gamma_g")
    _require_g2(pp.h, f"{what}.h")
    _require_g2(pp.beta_h, f"{what}.beta_h")
    for i, p in enumerate(pp.host_gamma_powers or []):
        _require_g1(p, f"{what}.host_gamma_powers[{i}]")
    for i, p in enumerate(pp.neg_powers_of_h or []):
        _require_g2(p, f"{what}.neg_powers_of_h[{i}]")
    return pp


def save_srs(pp: kzg.UniversalParams, path: str) -> None:
    """The archive contains only public SRS material (the setup trapdoor
    is discarded inside kzg.setup and cannot appear here)."""
    _atomic_savez(path, meta=json.dumps(_srs_meta(pp), default=str), **_srs_arrays(pp, ""))


def load_srs(path: str, device=None) -> kzg.UniversalParams:
    """SRS archive -> UniversalParams with the powers on `device`."""
    dev = resolve_device(device)
    meta, arrays = _load(path)
    return _srs_from(meta, arrays, "", dev, "srs")


def cached_srs(
    max_degree: int, rng, cache_dir: str | None = None, flavor: str = "marlin", device=None
) -> kzg.UniversalParams:
    """Generate-or-load an SRS for `max_degree` (bench/test convenience).

    flavor "sonic" additionally carries the negative G2 power table.  The
    default directory is this package's own, so an archive the JAX package
    wrote never stands in for one this package would make."""
    dev = resolve_device(device)
    cache_dir = cache_dir or os.path.expanduser("~/.cache/marlin_tpu_torch_srs")
    os.makedirs(cache_dir, exist_ok=True)
    suffix = "" if flavor == "marlin" else f"_{flavor}"
    # the active curve is part of the key: an SRS is a per-curve artifact
    curve = P.CURVE_NAME.replace("_", "")
    path = os.path.join(cache_dir, f"srs_{curve}_{max_degree}{suffix}.npz")
    if os.path.exists(path):
        pp = load_srs(path, dev)
        if flavor != "sonic" or pp.neg_powers_of_h is not None:
            return pp
    pp = kzg.setup(max_degree, rng, dev, neg_powers_of_h=(flavor == "sonic"))
    save_srs(pp, path)
    return pp


# --------------------------------------------------------------------------
# index keys


def _comm_to_meta(c) -> dict:
    return {
        "comm": list(c.comm) if c.comm is not None else None,
        "shifted": list(c.shifted_comm) if c.shifted_comm is not None else None,
    }


def _comm_from_meta(m) -> dict:
    """Commitment fields as plain data; commitments feed pairings, so each
    point must lie in the prime-order subgroup."""
    comm = tuple(int(v) for v in m["comm"]) if m["comm"] else None
    shifted = tuple(int(v) for v in m["shifted"]) if m["shifted"] else None
    _require_g1(comm, "index_comm", subgroup=True)
    _require_g1(shifted, "index_comm.shifted", subgroup=True)
    return {"comm": comm, "shifted_comm": shifted}


def _vk_meta(vk) -> dict:
    from . import sonic

    common = {
        "g": list(vk.g),
        "gamma_g": list(vk.gamma_g),
        "h": [list(vk.h[0]), list(vk.h[1])],
        "beta_h": [list(vk.beta_h[0]), list(vk.beta_h[1])],
    }
    if isinstance(vk, sonic.SonicVerifierKey):
        return {"flavor": "sonic", **common,
                "neg_h_powers": {str(b): [list(p[0]), list(p[1])] for b, p in vk.neg_h_powers.items()},
                "supported_degree": vk.supported_degree, "max_degree": vk.max_degree}
    return {"flavor": "marlin", **common,
            "shift_powers": {str(b): list(p) for b, p in vk.shift_powers.items()},
            "supported_degree": vk.supported_degree, "max_degree": vk.max_degree}


def _vk_from_meta(m) -> dict:
    """The PC verifier key's fields as plain data, validated."""
    tup = lambda v: tuple(int(x) for x in v)
    g2 = lambda v: (tup(v[0]), tup(v[1]))
    out = {
        "g": _require_g1(tup(m["g"]), "vk.g"),
        "gamma_g": _require_g1(tup(m["gamma_g"]), "vk.gamma_g"),
        "h": _require_g2(g2(m["h"]), "vk.h"),
        "beta_h": _require_g2(g2(m["beta_h"]), "vk.beta_h"),
        "supported_degree": m["supported_degree"],
        "max_degree": m["max_degree"],
    }
    if m["flavor"] == "sonic":
        out["neg_h_powers"] = {
            int(b): _require_g2(g2(p), f"vk.neg_h_powers[{b}]") for b, p in m["neg_h_powers"].items()
        }
    else:
        out["shift_powers"] = {
            int(b): _require_g1(tup(p), f"vk.shift_powers[{b}]") for b, p in m["shift_powers"].items()
        }
    return out


def _index_info_meta(info) -> dict:
    return {
        "num_variables": info.num_variables,
        "num_constraints": info.num_constraints,
        "num_non_zero": info.num_non_zero,
        "num_instance_variables": info.num_instance_variables,
    }


def _index_vk_meta(vk) -> dict:
    return {
        "index_info": _index_info_meta(vk.index_info),
        "index_comms": [_comm_to_meta(c) for c in vk.index_comms],
        "verifier_key": _vk_meta(vk.verifier_key),
    }


def _index_vk_plain(m: dict) -> dict:
    return {
        "index_info": {k: int(v) for k, v in m["index_info"].items()},
        "index_comms": [_comm_from_meta(c) for c in m["index_comms"]],
        "verifier_key": _vk_from_meta(m["verifier_key"]),
    }


def save_index_vk(vk, path: str) -> None:
    """IndexVerifierKey -> small npz (reference data_structures.rs:25-62)."""
    _atomic_savez(path, meta=json.dumps(_index_vk_meta(vk), default=str))


def load_index_vk(path: str, device=None):
    """IndexVerifierKey from its archive (host data only; `device` follows
    the rule of the other entry points)."""
    resolve_device(device)
    meta, _ = _load(path)
    return interop.verifier_key(_index_vk_plain(meta))


# archive names of the joint arithmetization and its evaluations on K
_JA = ("row", "col", "val_a", "val_b", "val_c", "row_col")
_EV = ("row", "col", "row_col", "val_a", "val_b", "val_c")


def save_index_pk(pk, path: str, include_srs: bool = True) -> None:
    """IndexProverKey -> npz (reference data_structures.rs:70-79).

    The archive is self-contained by default (committer-key powers
    included, as arkworks' derived serializer does); `include_srs=False`
    writes only the index material, for reattaching to a separately-stored
    SRS via `load_index_pk(path, srs=...)`."""
    ix = pk.index
    ja = ix.joint_arith
    ck = pk.committer_key
    meta = {
        "vk": _index_vk_meta(pk.index_vk),
        "ck": {
            "flavor": type(ck).__module__.rsplit(".", 1)[-1],
            "supported_degree": ck.supported_degree,
            "degree_bounds": list(ck.degree_bounds),
            "hiding_bound": ck.hiding_bound,
        },
        "domains": {"h": ix.domain_h.size, "k": ix.domain_k.size, "x": ix.domain_x.size},
        "include_srs": include_srs,
    }
    arrays = {}
    for name, mat in (("a", ix.a), ("b", ix.b), ("c", ix.c)):
        arrays[f"{name}_rows"] = _i32(mat.rows)
        arrays[f"{name}_cols"] = _i32(mat.cols)
        arrays[f"{name}_vals"] = _u32(mat.vals)
        arrays[f"{name}_reidx"] = _i32(mat.cols_reindexed)
        meta[f"{name}_shape"] = [mat.num_rows, mat.num_cols]
    for k in _JA:
        arrays[f"ja_{k}"] = _u32(getattr(ja, k))
    for k in _EV:
        arrays[f"ev_{k}"] = _u32(getattr(ja.evals_on_K, k))
    if include_srs:
        arrays.update(_srs_arrays(ck.pp, "srs_"))
        meta["srs"] = _srs_meta(ck.pp)
    _atomic_savez(path, meta=json.dumps(meta, default=str), **arrays)


def load_index_pk(path: str, srs: kzg.UniversalParams | None = None, device=None):
    """IndexProverKey from its archive, with its tensors on `device`.  An
    archive written with include_srs=False takes its SRS from `srs`, which
    must live on that device.  The powers of an SRS the archive carries
    are checked as `load_srs` checks them."""
    dev = resolve_device(device)
    meta, data = _load(path)
    if meta["include_srs"]:
        pp = _srs_from(meta["srs"], data, "srs_", dev, "pk.srs")
    elif srs is not None:
        _same_device(srs.device, dev, "the SRS")
        pp = srs
    else:
        raise ValueError("archive has no SRS; pass srs= to reattach one")

    index = {
        "index_info": meta["vk"]["index_info"],
        **{
            name: {
                "rows": data[f"{name}_rows"],
                "cols": data[f"{name}_cols"],
                "vals": data[f"{name}_vals"],
                "cols_reindexed": data[f"{name}_reidx"],
                "num_rows": meta[f"{name}_shape"][0],
                "num_cols": meta[f"{name}_shape"][1],
            }
            for name in "abc"
        },
        "joint_arith": {
            **{k: data[f"ja_{k}"] for k in _JA},
            "evals_on_K": {k: data[f"ev_{k}"] for k in _EV},
        },
        **{f"domain_{d}": {"size": int(meta["domains"][d])} for d in "hkx"},
    }
    ck = meta["ck"]
    vk = _index_vk_plain(meta["vk"])
    if (ck["flavor"] == "sonic") != ("neg_h_powers" in vk["verifier_key"]):
        raise ValueError(f"a {ck['flavor']} committer key with a {meta['vk']['verifier_key']['flavor']} verifier key")
    pk, _ = interop.index_keys({
        "index_vk": vk,
        "committer_key": {
            "pp": pp,
            "supported_degree": ck["supported_degree"],
            "degree_bounds": ck["degree_bounds"],
            "hiding_bound": ck["hiding_bound"],
        },
        "index_comm_rands": [{"blind": None, "shifted_blind": None} for _ in vk["index_comms"]],
        "index": index,
    }, dev)
    return pk
