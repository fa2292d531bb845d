"""Sonic-style KZG10 polynomial commitments ([MBKM19] / ark sonic_pc).

Port of `marlin_tpu/snark/sonic.py`, the reference's benchmark PC scheme
(benches/bench.rs:13,81).  Differences from the Marlin scheme in kzg.py
(SURVEY.md §2b row 4):

* a degree-bound-b polynomial has ONE commitment — to x^(D-b)·p directly,
  committed over shifted powers (enforced by the SRS range) — instead of a
  (comm, shifted_comm) pair; proofs are smaller (the reference's 784 vs
  880 bytes, README.md:85-88);
* the verifier "unshifts" inside the pairing using negative G2 powers
  τ^-(D-b)·h, contributing one extra Miller loop per distinct bound:
      e(C_b, τ^-(D-b) h) · e(-v·g - r(z)·γg, h) = e(W, (β-z) h)
  with the witness W = (p - v)/(x - z) committed over UNSHIFTED powers;
* hiding blinds of bounded polynomials are committed over gamma powers at
  the same shift so the unshifting pairing preserves the algebra.

The MSMs over the G1 powers take kzg.py's route (the table on the card);
those over the gamma powers, the blinds, have no table: on the card they
run on the ladder or the classic Pippenger of ops/msm.py::msm_many.  The
universal params carry the full table of negative G2 powers
(neg_powers_of_h[i] = τ^-i h), made inside `kzg.setup` as ark sonic_pc's
UniversalParams does; the trapdoor never outlives setup and `trim` only
selects the entries for the requested bounds.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import active as P
from ..fields import host_curve as hc
from ..fields import host_pairing as hp
from ..ops import fr, poly
from ..utils.rand import ZkRng
from . import kzg
from .kzg import (
    BatchLCProof,
    Commitment,
    PCError,
    PointProof,
    Randomness,
    UniversalParams,
    _combine_lc_polys,
    _group_query_set,
    _host_div_by_linear,
    _host_poly_eval,
    _rand_blind,
)
from .lc import ONE_TERM

R = P.R_MODULUS


@dataclass
class SonicCommitterKey:
    pp: UniversalParams
    supported_degree: int
    degree_bounds: list
    hiding_bound: int

    @property
    def max_degree(self) -> int:
        return self.pp.max_degree()


@dataclass
class SonicVerifierKey:
    g: tuple
    gamma_g: tuple
    h: tuple
    beta_h: tuple
    neg_h_powers: dict  # bound b -> host G2 affine tau^-(D-b) h
    supported_degree: int
    max_degree: int

    def get_neg_power(self, bound: int):
        if bound not in self.neg_h_powers:
            raise PCError(f"unsupported degree bound {bound}")
        return self.neg_h_powers[bound]


def setup(max_degree: int, rng: ZkRng, device) -> UniversalParams:
    """Sonic-flavored SRS: powers of τ in G1 on `device` plus ALL negative
    powers of τ in G2 (ark sonic_pc UniversalParams layout); trapdoor-free."""
    return kzg.setup(max_degree, rng, device, neg_powers_of_h=True)


def trim(
    pp: UniversalParams,
    supported_degree: int,
    supported_hiding_bound: int,
    degree_bounds: list | None,
):
    d = pp.max_degree()
    if supported_degree > d:
        raise PCError("trim degree exceeds SRS")
    if pp.neg_powers_of_h is None:
        raise PCError("sonic trim needs an SRS with negative G2 powers (sonic.setup)")
    bounds = sorted(degree_bounds or [])
    neg_h = {b: pp.neg_powers_of_h[d - b] for b in bounds}
    ck = SonicCommitterKey(
        pp=pp,
        supported_degree=supported_degree,
        degree_bounds=bounds,
        hiding_bound=supported_hiding_bound,
    )
    vk = SonicVerifierKey(
        g=pp.g,
        gamma_g=pp.gamma_g,
        h=pp.h,
        beta_h=pp.beta_h,
        neg_h_powers=neg_h,
        supported_degree=supported_degree,
        max_degree=d,
    )
    return ck, vk


def _run_jobs(ck: SonicCommitterKey, jobs: list, powers: str = "g") -> list:
    """MSM jobs over the G1 powers (or gamma powers) -> host affine."""
    if powers == "g":
        return kzg._run_msm_jobs(ck, jobs)
    return kzg._device_msm_jobs(ck.pp.powers_of_gamma_g, jobs, None)


def commit(ck: SonicCommitterKey, labeled_polys: list, rng: ZkRng | None):
    """Single (possibly shifted) commitment per polynomial."""
    device = ck.pp.device
    jobs = []
    gamma_jobs = []
    meta = []
    rands = []
    d = ck.max_degree
    for lp in labeled_polys:
        coeffs = lp.coeffs
        deg = coeffs.shape[0] - 1
        if deg > ck.supported_degree:
            raise PCError(f"{lp.label}: degree {deg} > supported {ck.supported_degree}")
        shift = 0
        if lp.degree_bound is not None:
            if lp.degree_bound not in ck.degree_bounds:
                raise PCError(f"{lp.label}: unsupported degree bound {lp.degree_bound}")
            if deg > lp.degree_bound:
                raise PCError(f"{lp.label}: degree {deg} exceeds bound {lp.degree_bound}")
            shift = d - lp.degree_bound
        r = Randomness.empty()
        entry = {"main": len(jobs), "gamma": None}
        jobs.append((shift, coeffs))
        if lp.hiding_bound is not None:
            assert rng is not None
            r.blind = _rand_blind(lp.hiding_bound, rng)
            entry["gamma"] = len(gamma_jobs)
            gamma_jobs.append((shift, fr.from_ints(r.blind, device)))
        meta.append(entry)
        rands.append(r)

    affs = _run_jobs(ck, jobs)
    gamma_affs = _run_jobs(ck, gamma_jobs, powers="gamma") if gamma_jobs else []
    out = []
    for e in meta:
        comm = affs[e["main"]]
        if e["gamma"] is not None:
            comm = hc.g1_add(comm, gamma_affs[e["gamma"]])
        out.append(Commitment(comm=comm, shifted_comm=None))
    return out, rands


def open_combinations(
    ck: SonicCommitterKey,
    lc_s: list,
    polys: dict,
    rands: dict,
    query_set: list,
    opening_challenge: int,
    lc_evals: dict | None = None,
) -> BatchLCProof:
    """One PointProof per query point; witnesses all over unshifted powers,
    gamma witnesses at each poly's shift."""
    device = ck.pp.device
    virtual = _combine_lc_polys(lc_s, polys, rands, device)
    per_point = []
    for _pl, z, labels in _group_query_set(query_set):
        z_dev = fr.from_int(z, device)
        z_inv = fr.inv(z_dev[None, :])  # shared by every label at this point
        chi = 1
        w_poly_acc = None
        gamma_jobs = []  # (shift, scalars)
        random_v = 0
        any_hiding = False
        for label in labels:
            v = virtual[label]
            w = poly.div_by_linear(v["coeffs"], z_dev, z_inv)
            scaled = poly.scale(w, fr.from_int(chi, device))
            w_poly_acc = scaled if w_poly_acc is None else poly.add(w_poly_acc, scaled)
            # witnesses (incl. gamma) are unshifted; see module doc
            if v["blind"] is not None:
                any_hiding = True
                random_v = (random_v + chi * _host_poly_eval(v["blind"], z)) % R
                wb = [chi * x % R for x in _host_div_by_linear(v["blind"], z)]
                if wb:
                    gamma_jobs.append((0, fr.from_ints(wb, device)))
            chi = chi * opening_challenge % R
        per_point.append(
            {
                "w_poly": w_poly_acc,
                "gamma_jobs": gamma_jobs,
                "random_v": random_v if any_hiding else None,
            }
        )

    all_jobs = [(0, p["w_poly"]) for p in per_point]
    affs = _run_jobs(ck, all_jobs)
    all_gamma = [j for p in per_point for j in p["gamma_jobs"]]
    gamma_affs = _run_jobs(ck, all_gamma, powers="gamma") if all_gamma else []
    proofs = []
    k = 0
    for p, w_aff in zip(per_point, affs):
        for _ in p["gamma_jobs"]:
            w_aff = hc.g1_add(w_aff, gamma_affs[k])
            k += 1
        proofs.append(PointProof(w=w_aff, random_v=p["random_v"]))
    return BatchLCProof(proofs=proofs)


def check_combinations(
    vk: SonicVerifierKey,
    lc_s: list,
    comms: dict,
    query_set: list,
    evaluations: dict,
    proof: BatchLCProof,
    opening_challenge: int,
    rng: ZkRng,
) -> bool:
    """Pairing product with one extra Miller loop per distinct degree bound."""
    # symbolic virtual commitments: label -> (entries [(coeff, point)], bound);
    # bounded LCs keep their group separate.  No group ops here — all terms
    # land in one flat host Pippenger per pairing slot below.
    virtual = {}
    for lc in lc_s:
        bound = None
        poly_terms = [(c, t) for c, t in lc.terms if t is not ONE_TERM]
        const = sum(c for c, t in lc.terms if t is ONE_TERM) % R
        entries = []
        for c, t in poly_terms:
            lcm = comms[t]
            if lcm.degree_bound is not None:
                if len(poly_terms) != 1:
                    return False
                bound = lcm.degree_bound
            entries.append((c, lcm.commitment.comm))
        if const:
            entries.append((const, vk.g))
        virtual[lc.label] = (entries, bound)

    groups = _group_query_set(query_set)
    if len(groups) != len(proof.proofs):
        return False

    h_pts: list = []  # slot paired with h
    h_scals: list = []
    beta_pts: list = []  # slot paired with beta_h
    beta_scals: list = []
    g_scalar = 0
    gamma_scalar = 0
    bound_msms: dict = {}  # bound -> (pts, scals) paired with neg_h[bound]
    for (pl, z, labels), pp_ in zip(groups, proof.proofs):
        u = rng.rand_fr()
        chi = 1
        for label in labels:
            entries, bound = virtual[label]
            if (label, z) not in evaluations:
                return False
            v = evaluations[(label, z)]
            coeff = u * chi % R
            if bound is None:
                for c, pt in entries:
                    h_pts.append(pt)
                    h_scals.append(coeff * c % R)
            else:
                b_pts, b_scals = bound_msms.setdefault(bound, ([], []))
                for c, pt in entries:
                    b_pts.append(pt)
                    b_scals.append(coeff * c % R)
            # value (and blind eval) terms always live in the h slot
            g_scalar = (g_scalar - coeff * v) % R
            chi = chi * opening_challenge % R
        if pp_.random_v is not None:
            gamma_scalar = (gamma_scalar - u * pp_.random_v) % R
        h_pts.append(pp_.w)
        h_scals.append(u * z % R)
        beta_pts.append(pp_.w)
        beta_scals.append(u)

    if not beta_pts:
        return False
    h_pts.append(vk.g)
    h_scals.append(g_scalar)
    if gamma_scalar:
        h_pts.append(vk.gamma_g)
        h_scals.append(gamma_scalar)
    acc_h = hc.g1_msm(h_pts, h_scals)
    acc_beta = hc.g1_msm(beta_pts, beta_scals)
    if acc_beta is None:
        return False
    pairs = [(acc_h, vk.h), (hc.g1_neg(acc_beta), vk.beta_h)]
    for b, (b_pts, b_scals) in bound_msms.items():
        pairs.append((hc.g1_msm(b_pts, b_scals), vk.get_neg_power(b)))
    return hp.multi_pairing(pairs)
