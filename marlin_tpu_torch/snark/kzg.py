"""KZG10 polynomial commitments with Marlin-style degree bounds and hiding.

Rebuild of the `ark-poly-commit` slice the reference pins (SURVEY.md §2b
row 4): `setup / trim / commit / open_combinations / check_combinations`,
`LabeledPolynomial`-style metadata, degree-bound *shifted* commitments
(needed for g_1 with bound |H|-2 and g_2 with bound |K|-2 — reference
src/ahp/prover.rs:561,700), hiding commitments (hiding bound 1,
src/lib.rs:114), and linear-combination batch openings.

Scheme math (MarlinKZG10 semantics):
  * commit(p) = p(τ)·g + r(τ)·γg                     (r: blinding poly)
  * degree-bound b: additionally commit x^(D-b)·p with shifted powers
  * open at z: combined witness W = Σ_j χ^j w_j with w = (p - p(z))/(x - z);
    a bounded poly consumes a second power χ^(j+1) whose witness is
    x^(D-b)·w committed at offset D-b
  * check: e(ΣC' - v·g - r_v·γg, h) = e(W, βh - z·h), where a bounded
    poly's C' term is shifted_comm - v·β^(D-b)g

Port of `marlin_tpu/snark/kzg.py`.  The witness polynomials are Fr tensors
on the SRS's device.  On an SRS on the card the MSMs run on the fixed-base
table path of ops/msm.py (the table is built once per SRS), or on the
classic Pippenger where the table is switched off or over its budget; on an
SRS on the CPU they take the host route.  The verifier's handful of group
ops and the pairings run on the host (the verifier is succinct, SURVEY.md
§3.4).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import torch

from ..fields import active as P
from ..fields import host_curve as hc
from ..fields import host_pairing as hp
from ..fields import native_curve as nc
from ..ops import curve_device as cd
from ..ops import fq, fr, msm, poly
from ..utils.rand import ZkRng
from ..utils import profiling
from .lc import ONE_TERM, LinearCombination

R = P.R_MODULUS


from .errors import PolynomialCommitmentError


class PCError(PolynomialCommitmentError):
    """KZG/commitment failure (Error::PolynomialCommitmentError arm)."""


# --------------------------------------------------------------------------
# keys


@dataclass
class UniversalParams:
    """Powers-of-τ SRS (kzg10::UniversalParams analog)."""

    powers_of_g: cd.Point  # [D+1] tensors, affine form (Z in {0,1})
    powers_of_gamma_g: cd.Point  # [D+2] tensors
    g: tuple  # host affine
    gamma_g: tuple
    h: tuple  # host G2 affine
    beta_h: tuple
    # host-side prefix of the gamma powers: blinding polynomials are tiny
    # (degree hiding_bound+1 = 2), so their MSMs run on the host
    host_gamma_powers: list = None
    # negative powers of tau in G2 (neg_powers_of_h[i] = tau^-i * h, host
    # affine), made at setup for Sonic SRSs as ark sonic_pc's
    # UniversalParams carries them; the trapdoor itself never outlives setup
    neg_powers_of_h: list | None = None

    def max_degree(self) -> int:
        return self.powers_of_g[0].shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.powers_of_g[0].device


@dataclass
class CommitterKey:
    pp: UniversalParams
    supported_degree: int
    degree_bounds: list  # sorted list of supported bounds
    hiding_bound: int

    @property
    def max_degree(self) -> int:
        return self.pp.max_degree()


@dataclass
class VerifierKey:
    g: tuple
    gamma_g: tuple
    h: tuple
    beta_h: tuple
    shift_powers: dict  # bound -> host affine G1 = tau^(D-b) g
    supported_degree: int
    max_degree: int

    def get_shift_power(self, bound: int):
        if bound not in self.shift_powers:
            raise PCError(f"unsupported degree bound {bound}")
        return self.shift_powers[bound]


@dataclass
class Commitment:
    comm: tuple | None  # host affine G1 (None = identity)
    shifted_comm: tuple | None = None


@dataclass
class Randomness:
    blind: list | None = None  # host int coeffs of the blinding poly
    shifted_blind: list | None = None

    @staticmethod
    def empty() -> "Randomness":
        return Randomness()


@dataclass
class PointProof:
    w: tuple | None  # host affine G1
    random_v: int | None


@dataclass
class BatchLCProof:
    proofs: list  # one PointProof per distinct query point (sorted order)
    # ark-poly-commit's BatchLCProof carries `evals: Option<Vec<F>>`
    # (always None from open_combinations); kept for byte-layout parity
    evals: list | None = None


# --------------------------------------------------------------------------
# setup / trim


def _g1_powers(scalars: list, device) -> tuple:
    """(Jacobian batch of [s·G] on `device` in affine form, host affine
    points of its first 8).  BLS12-381 takes the native C fixed-base routine
    (csrc/marlin_curve.c).  A curve without the native runtime, on the card,
    takes kernel 4's ladder (`msm.fixed_base_powers`) and one normalization
    on the card: the host Python body of `hc.g1_fixed_base_powers` would
    take minutes at an SRS of 2^16 powers; the affine points are the same.
    On the CPU it takes that host body, as the JAX package does."""
    if torch.device(device).type == "cuda" and not nc.available():
        pts = cd.normalize_batch(msm.fixed_base_powers(hc.G1_GEN, scalars, device))
        return pts, cd.to_affine_ints_host(tuple(c[:8] for c in pts))
    affine = hc.g1_fixed_base_powers(hc.G1_GEN, scalars)
    return cd.from_affine_ints(affine, device), affine[:8]


def setup(max_degree: int, rng: ZkRng, device, neg_powers_of_h: bool = False) -> UniversalParams:
    """Powers-of-τ generation (the trusted-setup artifact; reference
    PC::setup at src/lib.rs:93), through the native fixed-base routines
    (csrc/marlin_curve.c) for BLS12-381 and through `_g1_powers` for the
    other curves; the G1 powers land on `device`.

    With `neg_powers_of_h` the SRS also carries every negative power of τ
    in G2 (ark sonic_pc's UniversalParams layout), so the Sonic variant's
    trim works from the public SRS alone.  The trapdoor τ is local to this
    function — it is never stored.
    """
    tau = rng.rand_fr()
    gamma = rng.rand_fr()
    taus = [1] * (max_degree + 1)
    for i in range(1, max_degree + 1):
        taus[i] = taus[i - 1] * tau % R
    gammas = [gamma * t % R for t in taus] + [gamma * taus[-1] * tau % R]

    powers_g, _ = _g1_powers(taus, device)
    powers_gamma, gamma_head = _g1_powers(gammas, device)

    h = hc.G2_GEN
    beta_h = hc.g2_mul(h, tau)
    neg_h = None
    if neg_powers_of_h:
        tau_inv = pow(tau, -1, R)
        neg_taus = [1] * (max_degree + 1)
        for i in range(1, max_degree + 1):
            neg_taus[i] = neg_taus[i - 1] * tau_inv % R
        neg_h = hc.g2_fixed_base_powers(h, neg_taus)
    n_prefix = min(8, max_degree + 2)
    host_gamma = gamma_head[:n_prefix]
    return UniversalParams(
        powers_of_g=powers_g,
        powers_of_gamma_g=powers_gamma,
        g=hc.G1_GEN,
        gamma_g=host_gamma[0],
        h=h,
        beta_h=beta_h,
        host_gamma_powers=host_gamma,
        neg_powers_of_h=neg_h,
    )


def trim(
    pp: UniversalParams,
    supported_degree: int,
    supported_hiding_bound: int,
    degree_bounds: list | None,
) -> tuple[CommitterKey, VerifierKey]:
    """PC::trim (reference src/lib.rs:115-121)."""
    d = pp.max_degree()
    if supported_degree > d:
        raise PCError("trim degree exceeds SRS")
    bounds = sorted(degree_bounds or [])
    shift_powers = {}
    if bounds:
        idxs = torch.as_tensor([d - b for b in bounds], device=pp.device)
        affs = cd.to_affine_ints_host(cd.gather(pp.powers_of_g, idxs))
        shift_powers = dict(zip(bounds, affs))
    ck = CommitterKey(
        pp=pp,
        supported_degree=supported_degree,
        degree_bounds=bounds,
        hiding_bound=supported_hiding_bound,
    )
    vk = VerifierKey(
        g=pp.g,
        gamma_g=pp.gamma_g,
        h=pp.h,
        beta_h=pp.beta_h,
        shift_powers=shift_powers,
        supported_degree=supported_degree,
        max_degree=d,
    )
    return ck, vk


# --------------------------------------------------------------------------
# commit


def _rand_blind(hiding_bound: int, rng: ZkRng) -> list:
    # arkworks Randomness::rand uses a degree (hiding_bound + 1) poly
    return rng.rand_fr_list(hiding_bound + 2)


def _host_gamma_msm(ck: CommitterKey, coeffs: list):
    """Tiny blinding-poly MSM over the host gamma-power prefix."""
    prefix = ck.pp.host_gamma_powers
    if prefix is None or len(coeffs) > len(prefix):
        raise PCError("blinding polynomial exceeds host gamma-power prefix")
    return hc.g1_msm(prefix[: len(coeffs)], coeffs)


# below this total job size the MSMs run over a cached host copy of the
# (small) SRS instead of converting the device powers per job
_HOST_MSM_THRESHOLD = 2048
_HOST_POWERS_MAX = 4096


def _ensure_host_powers(pp: UniversalParams) -> list | None:
    """Lazily materialize host affine copies of the G1 powers (small SRS only)."""
    if getattr(pp, "_host_powers", None) is not None:
        return pp._host_powers
    n = pp.powers_of_g[0].shape[0]
    if n > _HOST_POWERS_MAX:
        return None
    pp._host_powers = cd.to_affine_ints_host(pp.powers_of_g)
    return pp._host_powers


def msm_table_mb(n_powers: int) -> float:
    """MB of the packed fixed-base table over n_powers powers: W·N rows of
    24 32-bit words (the Jacobian blocks of the build are transient)."""
    c = msm._fixed_c(n_powers)
    return msm.fixed_table_windows(c) * n_powers * 24 * 4 / 1e6


def _ensure_msm_table(pp: UniversalParams):
    """Fixed-base table over the G1 powers (ops/msm.msm_fixed_many), built
    once per SRS and cached on the params (kzg.py:268-292).  None for an SRS
    on the CPU, whose MSMs take the host route, and where the classic
    Pippenger serves instead: with MARLIN_TPU_MSM_TABLE=0, or when the table
    would exceed MARLIN_TPU_MSM_TABLE_MB (default 2400).  Both are read at
    every call, as is the window width (`msm._fixed_c`, which
    MARLIN_TPU_FIXED_C sets): a cached table of another width is rebuilt.
    None while a mesh is active: `msm_many` passes the table over then, and
    runs the sharded MSM."""
    from ..parallel import context as pctx

    if (pp.device.type != "cuda" or os.environ.get("MARLIN_TPU_MSM_TABLE") == "0"
            or pctx.current() is not None):
        return None
    n = pp.powers_of_g[0].shape[0]
    c = msm._fixed_c(n)
    table = getattr(pp, "_msm_table", None)
    if table is not None and table.c == c:
        return table
    if msm_table_mb(n) > float(os.environ.get("MARLIN_TPU_MSM_TABLE_MB", "2400")):
        return None
    with profiling.span("Precomputing fixed-base MSM table"):
        pp._msm_table = msm.build_fixed_table(pp.powers_of_g, c)
    return pp._msm_table


# exact reruns of a commit batch after a fold flag fired (see _run_msm_jobs)
STATS = {"exact_reruns": 0}


def _fetch_affine(stacked: cd.Point, flags: list) -> tuple:
    """ONE device-to-host copy of the Jacobian limbs and the fold flags ->
    (host affine points, whether a flag fired)."""
    n = stacked[0].shape[0]
    parts = [c.reshape(-1) for c in stacked]
    if flags:
        parts.append(torch.stack(flags).to(torch.int32))
    host = torch.cat(parts).cpu().numpy()
    size = n * fq.L
    x, y, z = (host[i * size : (i + 1) * size].reshape(n, fq.L) for i in range(3))
    return cd.affine_ints_from_raw(x, y, z), bool(host[3 * size :].any())


def _run_msm_jobs(ck: CommitterKey, jobs: list) -> list:
    """Run (offset, scalars_mont) MSM jobs over the G1 powers -> host affine."""
    total = sum(scal.shape[0] for _, scal in jobs)
    if total <= _HOST_MSM_THRESHOLD:
        host_powers = _ensure_host_powers(ck.pp)
        if host_powers is not None:
            out = []
            for off, scal in jobs:
                ints = fr.to_ints(scal)
                out.append(hc.g1_msm(host_powers[off : off + len(ints)], ints))
            return out
    return _device_msm_jobs(ck.pp.powers_of_g, jobs, _ensure_msm_table(ck.pp))


def _device_msm_jobs(powers: cd.Point, jobs: list, table) -> list:
    """The jobs through ops/msm.msm_many -> host affine points, with the
    points and the fold flags in one copy, and the exact rerun on a flag."""
    with profiling.span("msm jobs: dispatch"):
        jacs = msm.msm_many(powers, jobs, table=table)
        stacked = tuple(torch.cat([p[i] for p in jacs], dim=0) for i in range(3))
    with profiling.span("msm jobs: result fetch + normalize"):
        affs, fired = _fetch_affine(stacked, msm.pending_fold_flags())
    if fired:
        affs = _exact_rerun(powers, jobs)
    return affs


def _exact_rerun(powers: cd.Point, jobs: list) -> list:
    """After a fold flag — a table bucket overflowed its capacity (a
    degenerate scalar pattern) or a fast mixed add met P == Q — the batch
    reruns on the classic path with exact=True: no table (its capacity
    model is what failed), complete mixed adds, and overflowing windows on
    masked sums, so no flag can fire again (kzg.py:324-333)."""
    print("[kzg] fold flag fired: exact classic rerun", flush=True)
    STATS["exact_reruns"] += 1
    jacs = msm.msm_many(powers, jobs, exact=True)
    stacked = tuple(torch.cat([p[i] for p in jacs], dim=0) for i in range(3))
    affs, fired = _fetch_affine(stacked, msm.pending_fold_flags())
    if fired:
        raise PCError("the exact MSM rerun still reports a degenerate add")
    return affs


def commit(ck: CommitterKey, labeled_polys: list, rng: ZkRng | None):
    """-> (list[Commitment], list[Randomness]); labeled_polys entries expose
    .label / .coeffs / .degree_bound / .hiding_bound (reference PC::commit
    call sites src/lib.rs:125,172,193,213).

    All the round's MSMs run as one batch of jobs (msm_many); the tiny
    blinding-poly commitments are host group ops added after normalization.
    """
    jobs = []
    meta = []
    rands = []
    d = ck.max_degree
    for lp in labeled_polys:
        coeffs = lp.coeffs
        deg = coeffs.shape[0] - 1
        if deg > ck.supported_degree:
            raise PCError(f"{lp.label}: degree {deg} > supported {ck.supported_degree}")
        if lp.degree_bound is not None:
            if lp.degree_bound not in ck.degree_bounds:
                raise PCError(f"{lp.label}: unsupported degree bound {lp.degree_bound}")
            if deg > lp.degree_bound:
                raise PCError(f"{lp.label}: degree {deg} exceeds bound {lp.degree_bound}")
        r = Randomness.empty()
        entry = {"main": len(jobs), "shifted": None, "rand": r}
        jobs.append((0, coeffs))
        if lp.hiding_bound is not None:
            assert rng is not None
            r.blind = _rand_blind(lp.hiding_bound, rng)
        if lp.degree_bound is not None:
            entry["shifted"] = len(jobs)
            jobs.append((d - lp.degree_bound, coeffs))
            if lp.hiding_bound is not None:
                r.shifted_blind = _rand_blind(lp.hiding_bound, rng)
        meta.append(entry)
        rands.append(r)

    affs = _run_msm_jobs(ck, jobs)

    with profiling.span("commit: blinding + assembly"):
        out, rands = _assemble_commitments(ck, meta, rands, affs)
    return out, rands


def _assemble_commitments(ck, meta, rands, affs):
    out = []
    for e in meta:
        r = e["rand"]
        comm = affs[e["main"]]
        if r.blind is not None:
            comm = hc.g1_add(comm, _host_gamma_msm(ck, r.blind))
        shifted = None
        if e["shifted"] is not None:
            shifted = affs[e["shifted"]]
            if r.shifted_blind is not None:
                shifted = hc.g1_add(shifted, _host_gamma_msm(ck, r.shifted_blind))
        out.append(Commitment(comm=comm, shifted_comm=shifted))
    return out, rands


# --------------------------------------------------------------------------
# LC compilation (virtual oracles)


def _combine_lc_polys(lc_s: list, polys: dict, rands: dict, device):
    """Compile each LinearCombination into a virtual labeled polynomial +
    randomness (the default open_combinations/check_combinations path of
    ark-poly-commit, reference src/lib.rs:292-302,413-423)."""
    out = {}
    for lc in lc_s:
        vpoly = None
        vblind = None
        degree_bound = None
        hiding = False
        poly_terms = [(c, t) for c, t in lc.terms if t is not ONE_TERM]
        const = sum(c for c, t in lc.terms if t is ONE_TERM) % R
        bounded = [t for _, t in poly_terms if polys[t].degree_bound is not None]
        if bounded:
            if len(poly_terms) != 1:
                raise PCError(f"LC {lc.label}: degree-bounded poly in multi-term LC")
            degree_bound = polys[poly_terms[0][1]].degree_bound
        for c, t in poly_terms:
            lp = polys[t]
            scaled = poly.scale(lp.coeffs, fr.from_int(c, lp.coeffs.device))
            vpoly = scaled if vpoly is None else poly.add(vpoly, scaled)
            r = rands.get(t)
            if lp.hiding_bound is not None:
                hiding = True
            if r is not None and r.blind is not None:
                b = [c * x % R for x in r.blind]
                if vblind is None:
                    vblind = b
                else:
                    vblind = [
                        (u + v) % R
                        for u, v in zip(
                            vblind + [0] * max(0, len(b) - len(vblind)),
                            b + [0] * max(0, len(vblind) - len(b)),
                        )
                    ]
        if vpoly is None:
            vpoly = fr.zeros((1,), device)
        if const:
            cdev = fr.from_int(const, device)
            vpoly = vpoly.clone()
            vpoly[0] = fr.add(vpoly[0:1], cdev[None])[0]
        shifted_blind = None
        if degree_bound is not None:
            r = rands.get(poly_terms[0][1])
            if r is not None and r.shifted_blind is not None:
                c = poly_terms[0][0]
                shifted_blind = [c * x % R for x in r.shifted_blind]
        out[lc.label] = {
            "coeffs": vpoly,
            "degree_bound": degree_bound,
            "hiding": hiding,
            "blind": vblind,
            "shifted_blind": shifted_blind,
        }
    return out


@dataclass
class LabeledCommitment:
    """ark-poly-commit's LabeledCommitment: label + commitment + bound."""

    label: str
    commitment: Commitment
    degree_bound: int | None = None


# --------------------------------------------------------------------------
# open / check


def _group_query_set(query_set: list):
    """-> ordered [(point_label, point, sorted poly labels)]."""
    by_point = {}
    for label, (point_label, point) in query_set:
        by_point.setdefault((point_label, point), []).append(label)
    return [
        (pl, pt, sorted(labels)) for (pl, pt), labels in sorted(by_point.items())
    ]


def _host_poly_eval(coeffs: list, z: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % R
    return acc


def _host_div_by_linear(coeffs: list, z: int) -> list:
    """(p(x) - p(z))/(x - z) for tiny host polys (blinding randomness)."""
    out = [0] * (len(coeffs) - 1)
    acc = 0
    for i in range(len(coeffs) - 1, 0, -1):
        acc = (acc * z + coeffs[i]) % R
        out[i - 1] = acc
    return out


def open_combinations(
    ck: CommitterKey,
    lc_s: list,
    polys: dict,
    rands: dict,
    query_set: list,
    opening_challenge: int,
    lc_evals: dict | None = None,
) -> BatchLCProof:
    """Produce one PointProof per distinct query point.

    polys: label -> LabeledPoly; rands: label -> Randomness;
    query_set entries reference LC labels.
    """
    device = ck.pp.device
    with profiling.span("Combining LC polynomials"):
        virtual = _combine_lc_polys(lc_s, polys, rands, device)
    d = ck.max_degree
    per_point = []
    for _pl, z, labels in _group_query_set(query_set):
        z_dev = fr.from_int(z, device)
        z_inv = fr.inv(z_dev[None, :])  # shared by every label at this point
        chi = 1
        w_unshifted = None
        shifted_parts = {}  # bound -> accumulated witness poly
        gamma_blind = None  # combined randomness witness (host coeffs)
        random_v = 0
        any_hiding = False
        for label in labels:
            v = virtual[label]
            w = poly.div_by_linear(v["coeffs"], z_dev, z_inv)
            scaled = poly.scale(w, fr.from_int(chi, device))
            w_unshifted = scaled if w_unshifted is None else poly.add(w_unshifted, scaled)
            if v["blind"] is not None:
                any_hiding = True
                random_v = (random_v + chi * _host_poly_eval(v["blind"], z)) % R
                wb = [chi * x % R for x in _host_div_by_linear(v["blind"], z)]
                gamma_blind = wb if gamma_blind is None else [
                    (a + b) % R
                    for a, b in zip(
                        gamma_blind + [0] * max(0, len(wb) - len(gamma_blind)),
                        wb + [0] * max(0, len(gamma_blind) - len(wb)),
                    )
                ]
            chi = chi * opening_challenge % R
            if v["degree_bound"] is not None:
                b = v["degree_bound"]
                sw = poly.scale(w, fr.from_int(chi, device))
                shifted_parts[b] = (
                    sw if b not in shifted_parts else poly.add(shifted_parts[b], sw)
                )
                if v["shifted_blind"] is not None:
                    any_hiding = True
                    random_v = (random_v + chi * _host_poly_eval(v["shifted_blind"], z)) % R
                    wb = [chi * x % R for x in _host_div_by_linear(v["shifted_blind"], z)]
                    gamma_blind = wb if gamma_blind is None else [
                        (a + b2) % R
                        for a, b2 in zip(
                            gamma_blind + [0] * max(0, len(wb) - len(gamma_blind)),
                            wb + [0] * max(0, len(gamma_blind) - len(wb)),
                        )
                    ]
                chi = chi * opening_challenge % R

        jobs = [(0, w_unshifted)] + [(d - b, wp) for b, wp in shifted_parts.items()]
        per_point.append(
            {
                "jobs": jobs,
                "gamma_blind": gamma_blind,
                "random_v": random_v if any_hiding else None,
            }
        )

    # fuse every point's witness MSMs into one pass
    all_jobs = [j for p in per_point for j in p["jobs"]]
    with profiling.span("Committing to witness polynomials"):
        affs = _run_msm_jobs(ck, all_jobs)
    proofs = []
    k = 0
    for p in per_point:
        w_aff = affs[k]
        k += 1
        for _ in range(len(p["jobs"]) - 1):
            w_aff = hc.g1_add(w_aff, affs[k])
            k += 1
        if p["gamma_blind"]:
            w_aff = hc.g1_add(w_aff, _host_gamma_msm(ck, p["gamma_blind"]))
        proofs.append(PointProof(w=w_aff, random_v=p["random_v"]))
    return BatchLCProof(proofs=proofs)


def check_combinations(
    vk: VerifierKey,
    lc_s: list,
    comms: dict,
    query_set: list,
    evaluations: dict,
    proof: BatchLCProof,
    opening_challenge: int,
    rng: ZkRng,
) -> bool:
    """Succinct verification: one combined 2-Miller-loop pairing product.

    evaluations: (lc_label, point) -> claimed value.
    """
    # Symbolic LC expansion: label -> (entries [(coeff, point)], shifted
    # (coeff, point) | None, bound).  No group ops here — every term lands
    # in ONE flat host Pippenger below (the per-LC/per-label scalar-mul
    # version cost ~21 ladder calls per verify).
    lc_map = {}
    for lc in lc_s:
        poly_terms = [(c, t) for c, t in lc.terms if t is not ONE_TERM]
        const = sum(c for c, t in lc.terms if t is ONE_TERM) % R
        entries = []
        shifted = None
        bound = None
        for c, t in poly_terms:
            lcm = comms[t]
            entries.append((c, lcm.commitment.comm))
            if lcm.degree_bound is not None:
                if len(poly_terms) != 1:
                    raise PCError(f"LC {lc.label}: bounded commitment in multi-term LC")
                bound = lcm.degree_bound
                shifted = (c, lcm.commitment.shifted_comm)
        if const:
            entries.append((const, vk.g))
        lc_map[lc.label] = (entries, shifted, bound)

    groups = _group_query_set(query_set)
    if len(groups) != len(proof.proofs):
        return False

    # accumulate Σ_t u_t (C_t - v_t g - rv_t γg + z_t W_t) and Σ_t u_t W_t,
    # each as a single MSM over the expanded terms
    pts: list = []
    scals: list = []
    w_pts: list = []
    w_scals: list = []
    g_scalar = 0
    gamma_scalar = 0
    for (pl, z, labels), pp in zip(groups, proof.proofs):
        chi = 1
        comb_v = 0
        group_start = len(scals)  # u is sampled after the label walk; defer
        for label in labels:
            entries, shifted, bound = lc_map[label]
            if (label, z) not in evaluations:
                return False
            v = evaluations[(label, z)]
            for c, pt in entries:
                pts.append(pt)
                scals.append(chi * c % R)
            comb_v = (comb_v + chi * v) % R
            chi = chi * opening_challenge % R
            if bound is not None:
                # shifted term: χ'·(c·shifted_comm - v·τ^(D-b) g)
                sc, spt = shifted
                pts.append(spt)
                scals.append(chi * sc % R)
                pts.append(vk.get_shift_power(bound))
                scals.append(-(chi * v) % R)
                chi = chi * opening_challenge % R
        u = rng.rand_fr()
        for i in range(group_start, len(scals)):
            scals[i] = scals[i] * u % R
        g_scalar = (g_scalar - u * comb_v) % R
        if pp.random_v is not None:
            gamma_scalar = (gamma_scalar - u * pp.random_v) % R
        pts.append(pp.w)
        scals.append(u * z % R)
        w_pts.append(pp.w)
        w_scals.append(u)

    if not pts:
        return False
    pts.append(vk.g)
    scals.append(g_scalar)
    if gamma_scalar:
        pts.append(vk.gamma_g)
        scals.append(gamma_scalar)
    acc_lhs = hc.g1_msm(pts, scals)
    acc_w = hc.g1_msm(w_pts, w_scals)
    if acc_lhs is None:
        return False
    # e(acc_lhs, h) * e(-acc_w, beta_h) == 1
    return hp.multi_pairing([(acc_lhs, vk.h), (hc.g1_neg(acc_w), vk.beta_h)])
