"""Linear-combination algebra shared by prover and verifier.

Rebuild of `construct_linear_combinations` (reference src/ahp/mod.rs:110-221)
— the single source of truth for the AHP verifier equations, evaluated
against two EvaluationsProvider backends exactly like the reference
(polynomials for the prover at src/lib.rs:266, the proof's evaluation map
for the verifier at src/lib.rs:407).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..fields import active as P
from ..ops import fr, poly
from . import ahp
from .constraint_systems import format_public_input
from .domains import new_domain

R = P.R_MODULUS

ONE_TERM = None  # LCTerm::One


@dataclass
class LinearCombination:
    """label + list of (coeff, term) with term = poly label or ONE_TERM."""

    label: str
    terms: list = field(default_factory=list)

    def scaled(self, s: int) -> "LinearCombination":
        s %= R
        return LinearCombination(self.label, [(c * s % R, t) for c, t in self.terms])

    def poly_labels(self) -> list[str]:
        return [t for _, t in self.terms if t is not ONE_TERM]


from .errors import AHPError


class LcError(AHPError):
    """Linear-combination evaluation failure (MissingEval analog)."""


class PolyEvaluationsProvider:
    """Prover-side provider: evaluates oracle polynomials on their device
    (reference src/ahp/mod.rs:242-266)."""

    def __init__(self, polys: dict):
        # polys: label -> LabeledPoly (or raw coeff array)
        self.polys = polys
        self._cache: dict = {}

    def _eval(self, label: str, point: int) -> int:
        key = (label, point)
        if key not in self._cache:
            p = self.polys[label]
            coeffs = getattr(p, "coeffs", p)
            self._cache[key] = fr.to_int(poly.evaluate(coeffs, fr.from_int(point, coeffs.device)))
        return self._cache[key]

    def get_lc_eval(self, lc: LinearCombination, point: int) -> int:
        acc = 0
        for coeff, term in lc.terms:
            if term is ONE_TERM:
                acc = (acc + coeff) % R
            else:
                if term not in self.polys:
                    raise LcError(f"missing polynomial {term} for {lc.label}")
                acc = (acc + coeff * self._eval(term, point)) % R
        return acc


class MapEvaluationsProvider:
    """Verifier-side provider: looks up (lc.label, point) in the proof's
    evaluation map (reference src/ahp/mod.rs:233-240)."""

    def __init__(self, evals: dict):
        self.evals = evals  # (label, point) -> int

    def get_lc_eval(self, lc: LinearCombination, point: int) -> int:
        key = (lc.label, point)
        if key not in self.evals:
            raise LcError(f"missing evaluation for {lc.label}")
        return self.evals[key]


def construct_linear_combinations(public_input, evals, state) -> list[LinearCombination]:
    """Reference src/ahp/mod.rs:110-221; `state` is a VerifierState."""
    domain_h = state.domain_h
    domain_k = state.domain_k
    k_size = domain_k.size_as_field_element()

    formatted = format_public_input(public_input)
    if not ahp.num_formatted_inputs_is_admissible(len(formatted)):
        raise LcError("invalid public input length")
    x_domain = new_domain(len(formatted))

    fm = state.first_round_msg
    alpha, eta_a, eta_b, eta_c = fm.alpha, fm.eta_a, fm.eta_b, fm.eta_c
    beta = state.second_round_msg.beta
    gamma = state.gamma

    lcs: list[LinearCombination] = []

    # --- outer sumcheck -----------------------------------------------------
    z_b = LinearCombination("z_b", [(1, "z_b")])
    g_1 = LinearCombination("g_1", [(1, "g_1")])
    t = LinearCombination("t", [(1, "t")])

    r_alpha_at_beta = domain_h.eval_unnormalized_bivariate_lagrange_poly(alpha, beta)
    v_h_at_alpha = domain_h.evaluate_vanishing_polynomial(alpha)
    v_h_at_beta = domain_h.evaluate_vanishing_polynomial(beta)
    v_x_at_beta = x_domain.evaluate_vanishing_polynomial(beta)

    z_b_at_beta = evals.get_lc_eval(z_b, beta)
    t_at_beta = evals.get_lc_eval(t, beta)
    g_1_at_beta = evals.get_lc_eval(g_1, beta)

    lag = x_domain.evaluate_all_lagrange_coefficients(beta)
    x_at_beta = sum(l * x for l, x in zip(lag, formatted)) % R

    outer = LinearCombination(
        "outer_sumcheck",
        [
            (1, "mask_poly"),
            (r_alpha_at_beta * ((eta_a + eta_c * z_b_at_beta) % R) % R, "z_a"),
            (r_alpha_at_beta * eta_b % R * z_b_at_beta % R, ONE_TERM),
            ((-t_at_beta * v_x_at_beta) % R, "w"),
            ((-t_at_beta * x_at_beta) % R, ONE_TERM),
            ((-v_h_at_beta) % R, "h_1"),
            ((-beta * g_1_at_beta) % R, ONE_TERM),
        ],
    )

    if os.environ.get("MARLIN_TPU_DEBUG_CHECKS") == "1":
        # debug-mode self-check (reference debug_assert at src/ahp/mod.rs:177)
        assert evals.get_lc_eval(outer, beta) == 0, "outer sumcheck LC is nonzero"

    lcs.extend([z_b, g_1, t, outer])

    # --- inner sumcheck -----------------------------------------------------
    beta_alpha = beta * alpha % R
    g_2 = LinearCombination("g_2", [(1, "g_2")])
    g_2_at_gamma = evals.get_lc_eval(g_2, gamma)
    v_k_at_gamma = domain_k.evaluate_vanishing_polynomial(gamma)

    a = LinearCombination(
        "a_poly", [(eta_a, "a_val"), (eta_b, "b_val"), (eta_c, "c_val")]
    ).scaled(v_h_at_alpha * v_h_at_beta % R)

    b = LinearCombination(
        "denom",
        [
            (beta_alpha, ONE_TERM),
            ((-alpha) % R, "row"),
            ((-beta) % R, "col"),
            (1, "row_col"),
        ],
    ).scaled((gamma * g_2_at_gamma + t_at_beta * pow(k_size, -1, R)) % R)

    inner_terms = list(a.terms)
    inner_terms += [((-c) % R, t_) for c, t_ in b.terms]
    inner_terms += [((-v_k_at_gamma) % R, "h_2")]
    inner = LinearCombination("inner_sumcheck", inner_terms)

    if os.environ.get("MARLIN_TPU_DEBUG_CHECKS") == "1":
        # debug-mode self-check (reference debug_assert at src/ahp/mod.rs:214)
        assert evals.get_lc_eval(inner, gamma) == 0, "inner sumcheck LC is nonzero"

    lcs.extend([g_2, inner])
    lcs.sort(key=lambda l: l.label)
    return lcs
