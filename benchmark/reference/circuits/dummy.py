"""The R1CS of arkworks marlin's `DummyCircuit` (benches/bench.rs:25-67),
written out directly: what a constraint system makes of the circuit after
the input is padded to a power of two and the matrices are squared.

Columns: 0 the constant one, 1 the input c = a*b, then the witnesses a, b,
the num_variables - 3 copies of a, and the witnesses that square the
matrices (they appear in no constraint).  Rows: num_constraints - 1 times
a * b = c, then one empty constraint 0 * 0 = 0.
"""

from __future__ import annotations


def matrices(num_constraints: int, num_variables: int) -> tuple:
    """-> (num_instance, a, b, c): rows of (coefficient, column)."""
    num_instance = 2  # (1, c), already a power of two
    num_witness = 2 + (num_variables - 3)
    if num_instance + num_witness > num_constraints:
        raise ValueError("the reference squares only by adding witnesses")
    col_c, col_a, col_b = 1, num_instance, num_instance + 1
    a = [[(1, col_a)] for _ in range(num_constraints - 1)] + [[]]
    b = [[(1, col_b)] for _ in range(num_constraints - 1)] + [[]]
    c = [[(1, col_c)] for _ in range(num_constraints - 1)] + [[]]
    return num_instance, a, b, c


def public_input(r: int, a: int, b: int) -> list:
    return [a * b % r]
