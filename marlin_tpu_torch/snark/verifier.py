"""AHP verifier: challenge sampling and query set (reference src/ahp/verifier.rs).

All scalar work — the verifier is succinct, so this stays on the host.
The verifier's equation algebra lives in lc.py (shared with the prover, the
single-source-of-truth pattern of SURVEY.md §3.5).
"""

from __future__ import annotations

from dataclasses import dataclass

from .domains import Radix2Domain, new_domain
from .fs import FiatShamirRng
from .indexer import IndexInfo


from .errors import AHPError


class VerifierError(AHPError):
    """AHP verifier failure."""


@dataclass
class VerifierFirstMsg:
    alpha: int
    eta_a: int
    eta_b: int
    eta_c: int


@dataclass
class VerifierSecondMsg:
    beta: int


@dataclass
class VerifierState:
    domain_h: Radix2Domain
    domain_k: Radix2Domain
    first_round_msg: VerifierFirstMsg | None = None
    second_round_msg: VerifierSecondMsg | None = None
    gamma: int | None = None


def verifier_first_round(index_info: IndexInfo, fs: FiatShamirRng):
    """alpha (outside H), eta_a, eta_b, eta_c (reference verifier.rs:44-79)."""
    if index_info.num_constraints != index_info.num_variables:
        raise VerifierError("non-square constraint matrices")
    domain_h = new_domain(index_info.num_constraints)
    domain_k = new_domain(index_info.num_non_zero)

    alpha = domain_h.sample_element_outside_domain(fs.rand_fr)
    eta_a = fs.rand_fr()
    eta_b = fs.rand_fr()
    eta_c = fs.rand_fr()
    msg = VerifierFirstMsg(alpha, eta_a, eta_b, eta_c)
    return msg, VerifierState(domain_h, domain_k, first_round_msg=msg)


def verifier_second_round(state: VerifierState, fs: FiatShamirRng):
    beta = state.domain_h.sample_element_outside_domain(fs.rand_fr)
    msg = VerifierSecondMsg(beta)
    state.second_round_msg = msg
    return msg, state


def verifier_third_round(state: VerifierState, fs: FiatShamirRng):
    state.gamma = fs.rand_fr()
    return state


def verifier_query_set(state: VerifierState):
    """Six queries at beta / gamma (reference verifier.rs:103-188).

    Returned sorted by (label, point_label, point) — the BTreeSet iteration
    order the reference relies on for evaluation ordering (src/lib.rs:274).
    """
    beta = state.second_round_msg.beta
    gamma = state.gamma
    qs = [
        ("g_1", ("beta", beta)),
        ("z_b", ("beta", beta)),
        ("t", ("beta", beta)),
        ("outer_sumcheck", ("beta", beta)),
        ("g_2", ("gamma", gamma)),
        ("inner_sumcheck", ("gamma", gamma)),
    ]
    return sorted(qs), state
