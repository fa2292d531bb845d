"""AHP prover: three rounds of oracle polynomials (reference src/ahp/prover.rs).

Port of `marlin_tpu/snark/prover.py`.  The round cores are plain functions
over Fr tensors on the index's device: every field product, sum, inversion
and NTT in them launches the CUDA kernels on the card.  The host sequences
rounds and moves only challenge scalars and final evaluations.

Round structure:
  init   — Prove-mode synthesis, padding, z_A = Az / z_B = Bz sparse SpMV
  round1 — x̂/w LDEs, blinded ẑ_A/ẑ_B, mask polynomial
  round2 — outer sumcheck: t, g_1, h_1 via the ~3|H| mul-domain combine
  round3 — inner sumcheck over K: g_2, h_2 via batched inversion
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..fields import active as P
from ..ops import fr, ntt, poly, sparse
from ..utils import profiling
from ..utils.rand import ZkRng
from . import ahp
from .constraint_systems import (
    make_matrices_square,
    pad_input_for_indexer_and_prover,
    unformat_public_input,
)
from .domains import Radix2Domain, compute_size_of_domain
from .errors import AHPError
from .indexer import Index
from .r1cs import ConstraintSystem, OptimizationGoal, SynthesisMode

R = P.R_MODULUS


class ProvingError(AHPError):
    """AHP prover failure."""


@dataclass
class LabeledPoly:
    """Coefficient-form oracle with PC metadata (ark-poly-commit's
    LabeledPolynomial: label, degree_bound, hiding_bound)."""

    label: str
    coeffs: torch.Tensor  # [len, 16] Montgomery limbs
    degree_bound: int | None = None
    hiding_bound: int | None = None


@dataclass
class ProverState:
    """Reference src/ahp/prover.rs:27-63."""

    formatted_input: list  # ints
    witness: list  # ints
    z_a: torch.Tensor  # [|H|, 16] evals
    z_b: torch.Tensor
    index: Index
    domain_h: Radix2Domain
    domain_k: Radix2Domain
    domain_x: Radix2Domain
    zk_bound: int = ahp.ZK_BOUND
    w_poly: LabeledPoly | None = None
    z_a_poly: LabeledPoly | None = None
    z_b_poly: LabeledPoly | None = None
    mask_poly: LabeledPoly | None = None
    x_poly: torch.Tensor | None = None
    verifier_first_msg: object = None

    @property
    def device(self) -> torch.device:
        return self.z_a.device

    def public_input(self) -> list:
        return unformat_public_input(self.formatted_input)


def prover_init(index: Index, circuit) -> ProverState:
    """Reference src/ahp/prover.rs:211-306."""
    cs = ConstraintSystem(mode=SynthesisMode.PROVE, optimization_goal=OptimizationGoal.WEIGHT)
    circuit.generate_constraints(cs)
    with profiling.span("R1CS::finalize"):
        pad_input_for_indexer_and_prover(cs)
        cs.finalize()
        make_matrices_square(cs)

    info = index.index_info
    num_vars = cs.num_instance_variables + cs.num_witness_variables
    if cs.num_constraints != info.num_constraints or num_vars != info.num_variables:
        raise ProvingError("instance does not match index")
    if not ahp.num_formatted_inputs_is_admissible(cs.num_instance_variables):
        raise ProvingError("formatted public input length must be a power of two")

    z = fr.from_ints_via_device(cs.full_assignment(), index.device)
    z_a = sparse.spmv(index.a, z, index.domain_h.size)
    z_b = sparse.spmv(index.b, z, index.domain_h.size)

    return ProverState(
        formatted_input=list(cs.instance_assignment),
        witness=list(cs.witness_assignment),
        z_a=z_a,
        z_b=z_b,
        index=index,
        domain_h=index.domain_h,
        domain_k=index.domain_k,
        domain_x=index.domain_x,
    )


def _poly_degree(coeffs) -> int:
    """Index of the last nonzero coefficient (-1 for the zero poly).
    Debug-check helper, only called under MARLIN_TPU_DEBUG_CHECKS=1."""
    ints = fr.to_ints(coeffs)
    for i in range(len(ints) - 1, -1, -1):
        if ints[i]:
            return i
    return -1


def _assert_degree_le(coeffs, bound: int, label: str) -> None:
    d = _poly_degree(coeffs)
    assert d <= bound, f"{label} degree {d} exceeds bound {bound}"


def _assert_degree_lt(coeffs, bound: int, label: str) -> None:
    d = _poly_degree(coeffs)
    assert d < bound, f"{label} degree {d} not < {bound}"


def _set_row(t: torch.Tensor, i: int, value: torch.Tensor) -> torch.Tensor:
    out = t.clone()
    out[i] = value.reshape(-1)
    return out


# --------------------------------------------------------------------------
# round 1


def _round1_core(x_assign, w_ext, z_a_evals, z_b_evals, blinds, mask_raw, *, h, x_size):
    """First round (reference prover.rs:309-409).

    x_assign: [x_size,16]; w_ext: [h-x_size,16] (witness, zero-padded);
    blinds: [3,16] (w, z_a, z_b vanishing blinds); mask_raw: [3h,16].
    """
    dev = x_assign.device
    ratio = h // x_size

    x_poly = ntt.intt(x_assign)
    x_evals = ntt.ntt(x_poly, h)

    k = np.arange(h)
    on_input = k % ratio == 0
    widx = np.where(on_input, 0, k - k // ratio - 1)
    gathered = w_ext[torch.as_tensor(widx, device=dev)] if h > x_size else fr.zeros((h,), dev)
    w_evals = fr.select(
        torch.as_tensor(~on_input, device=dev), fr.sub(gathered, x_evals), fr.zeros((h,), dev)
    )

    def blind_with_vanishing(p, r):
        out = poly.pad_to(p, h + 1)
        out = _set_row(out, 0, fr.sub(out[0:1], r[None]))
        return _set_row(out, h, fr.add(out[h : h + 1], r[None]))

    # the three size-h interpolations are independent -> one batched launch
    w_i, z_a_i, z_b_i = ntt.intt_many([w_evals, z_a_evals, z_b_evals])
    w_over_h = blind_with_vanishing(w_i, blinds[0])
    w_poly, _rem = poly.divide_by_vanishing(w_over_h, x_size)
    z_a_poly = blind_with_vanishing(z_a_i, blinds[1])
    z_b_poly = blind_with_vanishing(z_b_i, blinds[2])

    # Σ_H mask = 0: subtract Σ_i mask[i*h] from the constant coefficient
    # (reference prover.rs:369-381; degree 3h + 2zk - 3 with zk = 1)
    r0 = fr.add(fr.add(mask_raw[0:1], mask_raw[h : h + 1]), mask_raw[2 * h : 2 * h + 1])
    mask = _set_row(mask_raw, 0, fr.sub(mask_raw[0:1], r0))

    return w_poly, z_a_poly, z_b_poly, mask, x_poly


def prover_first_round(state: ProverState, zk_rng: ZkRng):
    """Reference src/ahp/prover.rs:309-409 -> (oracles dict, state)."""
    h = state.domain_h.size
    x_size = state.domain_x.size
    zk = state.zk_bound
    dev = state.device

    w_ext_len = max(h - x_size, 1)
    w_ext = state.witness + [0] * (w_ext_len - len(state.witness))
    mask_len = 3 * h + 2 * zk - 2  # degree + 1 = 3h for zk = 1
    # zk-rng order: the mask limbs, then the three blinds
    mask_raw = fr.from_canonical_limbs(zk_rng.rand_fr_limbs(mask_len), dev)
    blinds = fr.from_ints([zk_rng.rand_fr() for _ in range(3)], dev)

    w_poly, z_a_poly, z_b_poly, mask, x_poly = _round1_core(
        fr.from_ints(state.formatted_input, dev),
        fr.from_ints_via_device(w_ext, dev),
        state.z_a,
        state.z_b,
        blinds,
        mask_raw,
        h=h,
        x_size=x_size,
    )

    if os.environ.get("MARLIN_TPU_DEBUG_CHECKS") == "1":
        # reference prover.rs:385-388 (debug-profile assert!s)
        _assert_degree_lt(w_poly, h - x_size + zk, "w")
        _assert_degree_lt(z_a_poly, h + zk, "z_a")
        _assert_degree_lt(z_b_poly, h + zk, "z_b")
        _assert_degree_le(mask, 3 * h + 2 * zk - 3, "mask_poly")

    oracles = {
        "w": LabeledPoly("w", w_poly, None, 1),
        "z_a": LabeledPoly("z_a", z_a_poly, None, 1),
        "z_b": LabeledPoly("z_b", z_b_poly, None, 1),
        "mask_poly": LabeledPoly("mask_poly", mask, None, None),
    }
    state.w_poly = oracles["w"]
    state.z_a_poly = oracles["z_a"]
    state.z_b_poly = oracles["z_b"]
    state.mask_poly = oracles["mask_poly"]
    state.x_poly = x_poly
    return oracles, state


# --------------------------------------------------------------------------
# round 2


def _batch_eval_bivariate_diff_dev(h: int, alpha, vanish_alpha):
    """u_H(alpha, y) for all y in H ([16] scalars in, [h,16] out)."""
    elems = ntt.domain_elements(h, alpha.device)
    diffs = fr.sub(alpha[None, :], elems)
    invs = fr.inv(diffs)
    return fr.mul(invs, vanish_alpha[None, :])


def _round2_core(
    z_a_p,
    z_b_p,
    mask,
    w_poly,
    x_poly,
    alpha,
    vanish_alpha,
    etas,  # [3,16]
    mat_rows,
    mat_cols_reidx,
    mat_vals,
    mat_seg,  # [nnz_total] in {0,1,2}: which matrix each entry belongs to
    *,
    h,
    x_size,
    n_mul,
):
    """Second round (reference prover.rs:443-570)."""
    # summed_z_m = eta_a z_a + eta_b z_b + eta_c (z_a * z_b)
    z_c = poly.mul(z_a_p, z_b_p)
    summed_z_m = poly.scale(z_c, etas[2])
    summed_z_m = poly.add(
        summed_z_m, poly.add(poly.scale(z_a_p, etas[0]), poly.scale(z_b_p, etas[1]))
    )

    r_alpha_evals = _batch_eval_bivariate_diff_dev(h, alpha, vanish_alpha)

    # t = Σ_M eta_M M^T r_alpha (scatter over reindexed columns)
    vals_scaled = fr.mul(mat_vals, etas[mat_seg])
    contrib = fr.mul(vals_scaled, r_alpha_evals[mat_rows])
    t_evals = sparse.scatter_add_mod(contrib, mat_cols_reidx, h)
    # both size-h interpolations batch into one launch
    r_alpha_poly, t_poly = ntt.intt_many([r_alpha_evals, t_evals])

    z_poly = poly.add(poly.mul_by_vanishing(w_poly, x_size), x_poly)

    # the four forward NTTs onto the mul domain are independent
    ra_e, szm_e, z_e, t_e = ntt.ntt_many([r_alpha_poly, summed_z_m, z_poly, t_poly], n_mul)
    rhs = ntt.intt(fr.sub(fr.mul(ra_e, szm_e), fr.mul(z_e, t_e)))
    q_1 = poly.add(mask, rhs)

    h_1, x_g_1 = poly.divide_by_vanishing(q_1, h)
    g_1 = x_g_1[1:]
    return t_poly, g_1, h_1


def prover_second_round(ver_msg, state: ProverState, zk_rng: ZkRng):
    """Reference src/ahp/prover.rs:443-570 -> (oracles dict, state)."""
    h = state.domain_h.size
    x_size = state.domain_x.size
    ix = state.index
    dev = state.device

    mask_len = state.mask_poly.coeffs.shape[0]
    za_len = state.z_a_poly.coeffs.shape[0]
    mul_size = max(mask_len, h + 2 * za_len - 1, 2 * h + x_size + 2)
    # GeneralEvaluationDomain::new over the operand-degree sum
    # (reference src/ahp/prover.rs:522-531)
    n_mul = compute_size_of_domain(mul_size)
    if n_mul is None:
        raise ValueError(f"no evaluation domain of size >= {mul_size}")

    mat_rows = torch.cat([ix.a.rows, ix.b.rows, ix.c.rows])
    mat_cols = torch.cat([ix.a.cols_reindexed, ix.b.cols_reindexed, ix.c.cols_reindexed])
    mat_vals = torch.cat([ix.a.vals, ix.b.vals, ix.c.vals])
    mat_seg = torch.cat(
        [
            torch.zeros((ix.a.nnz,), dtype=torch.int64, device=dev),
            torch.ones((ix.b.nnz,), dtype=torch.int64, device=dev),
            torch.full((ix.c.nnz,), 2, dtype=torch.int64, device=dev),
        ]
    )

    t_poly, g_1, h_1 = _round2_core(
        state.z_a_poly.coeffs,
        state.z_b_poly.coeffs,
        state.mask_poly.coeffs,
        state.w_poly.coeffs,
        state.x_poly,
        fr.from_int(ver_msg.alpha, dev),
        fr.from_int(state.domain_h.evaluate_vanishing_polynomial(ver_msg.alpha), dev),
        fr.from_ints([ver_msg.eta_a, ver_msg.eta_b, ver_msg.eta_c], dev),
        mat_rows,
        mat_cols,
        mat_vals,
        mat_seg,
        h=h,
        x_size=x_size,
        n_mul=n_mul,
    )

    # q_1's analytic degree is <= mul_size - 1; a mixed-radix mul domain can
    # overshoot it by more than the radix-2 2x, which would pad h_1 past the
    # SRS bound: drop the provably-zero tail there, keeping h_1 at its exact
    # degree (<= mul_size - 1 - h).  Power-of-two domains keep their padded
    # length, as the JAX package does (marlin_tpu/snark/prover.py:364-373).
    if n_mul & (n_mul - 1) and h_1.shape[0] > mul_size - h:
        h_1 = h_1[: mul_size - h]

    if os.environ.get("MARLIN_TPU_DEBUG_CHECKS") == "1":
        # reference prover.rs:516,556-557
        zk = state.zk_bound
        _assert_degree_le(g_1, h - 2, "g_1")
        _assert_degree_le(h_1, 2 * h + 2 * zk - 2, "h_1")

    oracles = {
        "t": LabeledPoly("t", t_poly, None, None),
        "g_1": LabeledPoly("g_1", g_1, h - 2, 1),
        "h_1": LabeledPoly("h_1", h_1, None, None),
    }
    state.verifier_first_msg = ver_msg
    return oracles, state


# --------------------------------------------------------------------------
# round 3


def _round3_core(
    val_a,
    val_b,
    val_c,
    row_k,
    col_k,
    row_col_k,
    val_a_k,
    val_b_k,
    val_c_k,
    coeffs_abc,  # [3,16] eta_M * v_H(alpha) v_H(beta)
    alpha,
    beta,
    alpha_beta,
    *,
    k,
):
    """Third round (reference prover.rs:588-706)."""
    a_poly = fr.add(
        fr.add(fr.mul(val_a, coeffs_abc[0][None, :]), fr.mul(val_b, coeffs_abc[1][None, :])),
        fr.mul(val_c, coeffs_abc[2][None, :]),
    )

    b_evals = fr.add(
        fr.sub(
            fr.sub(alpha_beta[None, :], fr.mul(row_k, alpha[None, :])),
            fr.mul(col_k, beta[None, :]),
        ),
        row_col_k,
    )

    denom = fr.mul(fr.sub(beta[None, :], row_k), fr.sub(alpha[None, :], col_k))
    inverses = fr.inv(denom)
    vals_combined = fr.add(
        fr.add(
            fr.mul(val_a_k, coeffs_abc[0][None, :]), fr.mul(val_b_k, coeffs_abc[1][None, :])
        ),
        fr.mul(val_c_k, coeffs_abc[2][None, :]),
    )
    f_evals = fr.mul(inverses, vals_combined)
    # both size-|K| interpolations batch into one launch
    b_poly, f = ntt.intt_many([b_evals, f_evals])
    g_2 = f[1:]

    bf = poly.mul(b_poly, f)
    h_2, _ = poly.divide_by_vanishing(poly.sub(a_poly, bf), k)
    return g_2, h_2


def prover_third_round(ver_msg, state: ProverState, zk_rng: ZkRng):
    """Reference src/ahp/prover.rs:588-706 -> oracles dict."""
    k = state.domain_k.size
    fm = state.verifier_first_msg
    alpha, beta = fm.alpha, ver_msg.beta
    dev = state.device

    v_h_a = state.domain_h.evaluate_vanishing_polynomial(alpha)
    v_h_b = state.domain_h.evaluate_vanishing_polynomial(beta)
    vv = v_h_a * v_h_b % R

    ja = state.index.joint_arith
    ev = ja.evals_on_K
    g_2, h_2 = _round3_core(
        ja.val_a,
        ja.val_b,
        ja.val_c,
        ev.row,
        ev.col,
        ev.row_col,
        ev.val_a,
        ev.val_b,
        ev.val_c,
        fr.from_ints([fm.eta_a * vv % R, fm.eta_b * vv % R, fm.eta_c * vv % R], dev),
        fr.from_int(alpha, dev),
        fr.from_int(beta, dev),
        fr.from_int(alpha * beta % R, dev),
        k=k,
    )

    if os.environ.get("MARLIN_TPU_DEBUG_CHECKS") == "1":
        # reference prover.rs:697-698
        _assert_degree_le(h_2, k - 2, "h_2")
        _assert_degree_le(g_2, k - 2, "g_2")

    return {
        "g_2": LabeledPoly("g_2", g_2, k - 2, None),
        "h_2": LabeledPoly("h_2", h_2, None, None),
    }
