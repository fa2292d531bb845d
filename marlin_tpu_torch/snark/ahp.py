"""AHP protocol constants and degree accounting.

Mirror of the umbrella items in reference src/ahp/mod.rs: polynomial labels,
zero-evaluating linear combinations, `max_degree`, and `get_degree_bounds`.
"""

from __future__ import annotations

from .domains import compute_size_of_domain

# reference src/ahp/mod.rs:33-36
INDEXER_POLYNOMIALS = ["row", "col", "a_val", "b_val", "c_val", "row_col"]
# reference src/ahp/mod.rs:40-45
PROVER_POLYNOMIALS = ["w", "z_a", "z_b", "mask_poly", "t", "g_1", "h_1", "g_2", "h_2"]
# reference src/ahp/mod.rs:48
LC_WITH_ZERO_EVAL = ["inner_sumcheck", "outer_sumcheck"]

ZK_BOUND = 1  # reference src/ahp/prover.rs:278


def polynomial_labels() -> list[str]:
    return INDEXER_POLYNOMIALS + PROVER_POLYNOMIALS


def num_formatted_inputs_is_admissible(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def max_degree(num_constraints: int, num_variables: int, num_non_zero: int) -> int:
    """Reference src/ahp/mod.rs:71-93."""
    padded = max(num_variables, num_constraints)
    zk = ZK_BOUND
    h = compute_size_of_domain(padded)
    k = compute_size_of_domain(num_non_zero)
    if h is None or k is None:
        raise ValueError("domain too large for the field's two-adic subgroup")
    return max(2 * h + zk - 2, 3 * h + 2 * zk - 3, h, h, k - 1)


def get_degree_bounds(info) -> list[int]:
    """[|H|-2, |K|-2] — bounds for g_1 and g_2 (reference src/ahp/mod.rs:96-106)."""
    h = compute_size_of_domain(info.num_constraints)
    k = compute_size_of_domain(info.num_non_zero)
    return [h - 2, k - 2]


def first_round_degree_bounds(info) -> list:
    return [None, None, None, None]  # w, z_a, z_b, mask_poly


def second_round_degree_bounds(info) -> list:
    h = compute_size_of_domain(info.num_constraints)
    return [None, h - 2, None]  # t, g_1, h_1


def third_round_degree_bounds(info) -> list:
    k = compute_size_of_domain(info.num_non_zero)
    return [k - 2, None]  # g_2, h_2
