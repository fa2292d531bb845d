"""R1CS constraint-system builder with ark-relations semantics.

Host-side circuit synthesis (the reference also synthesizes on the CPU —
`generate_constraints` at src/ahp/indexer.rs:158 / src/ahp/prover.rs:223);
the output is static COO sparse matrices plus assignment vectors that the
device AHP kernels consume.

Reproduced surface (SURVEY.md §2b row 5):
  * instance/witness variables with the implicit leading One
    (instance_assignment[0] = 1),
  * symbolic linear combinations (`new_lc`) and `enforce_constraint`,
  * `SynthesisMode::{Setup, Prove}`,
  * `finalize()` with inlining (Constraints goal) and outlining (Weight
    goal — the mode Marlin uses, src/ahp/indexer.rs:156),
  * `to_matrices()` -> sparse rows of (coeff, col) sorted by column.

Outlining semantics follow ark-relations 0.3's `outline_lcs` nnz cost
model: an LC is outlined into a fresh witness w plus a constraint
`lc * 1 = w` iff  t*l > t + 2 + l  with t = (#references from other LCs)+1
and l = the inlined length (see `_outline_lcs`).  Row LCs (t = 1) never
outline; the chain shape of ark-relations' OutlineTestCircuit (reference
src/test.rs:53-114) outlines exactly at inlined length 5.  Both indexer
and prover run the same deterministic pass — the invariant Marlin needs
(num_constraints / num_non_zero must agree between index and prove).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from ..fields import active as P

R = P.R_MODULUS

# Variable encoding: (kind, index).  Kind order defines term sort order,
# matching ark-relations' `Variable` Ord (One < Instance < Witness < SymbolicLc).
ONE = 0
INSTANCE = 1
WITNESS = 2
SYMBOLIC = 3

Variable = tuple[int, int]
VAR_ONE: Variable = (ONE, 0)


def lc(*terms) -> list:
    """Build a linear combination: lc((coeff, var), var2, ...).

    Bare variables get coefficient 1 (like the reference's `lc!() + a`).
    """
    out = []
    for t in terms:
        if isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], int) and isinstance(t[1], tuple):
            out.append((t[0] % R, t[1]))
        else:
            out.append((1, t))
    return _merge(out)


def _merge(terms: list) -> list:
    """Sort by variable and merge duplicates (LinearCombination semantics)."""
    terms = sorted(terms, key=lambda t: t[1])
    out = []
    for c, v in terms:
        if out and out[-1][1] == v:
            out[-1] = ((out[-1][0] + c) % R, v)
        else:
            out.append((c % R, v))
    return [(c, v) for c, v in out if c != 0]


def lc_add(a: list, b: list) -> list:
    return _merge(list(a) + list(b))


def lc_scale(a: list, s: int) -> list:
    s %= R
    return [(c * s % R, v) for c, v in a if c * s % R != 0]


class SynthesisMode(Enum):
    SETUP = "setup"
    PROVE = "prove"


class OptimizationGoal(Enum):
    CONSTRAINTS = "constraints"  # inline all LCs
    WEIGHT = "weight"  # outline reused LCs (Marlin's choice)


@dataclass
class ConstraintSystem:
    mode: SynthesisMode = SynthesisMode.PROVE
    optimization_goal: OptimizationGoal = OptimizationGoal.WEIGHT

    num_instance_variables: int = 1
    num_witness_variables: int = 0
    instance_assignment: list = field(default_factory=lambda: [1])
    witness_assignment: list = field(default_factory=list)

    # lc_map[i] = term list; rows reference LCs by index
    lc_map: list = field(default_factory=list)
    a_rows: list = field(default_factory=list)
    b_rows: list = field(default_factory=list)
    c_rows: list = field(default_factory=list)

    finalized: bool = False

    # ---- variable allocation -------------------------------------------------

    @property
    def num_constraints(self) -> int:
        return len(self.a_rows)

    @property
    def is_setup(self) -> bool:
        return self.mode == SynthesisMode.SETUP

    def new_input_variable(self, value_fn=None) -> Variable:
        idx = self.num_instance_variables
        self.num_instance_variables += 1
        if not self.is_setup:
            assert value_fn is not None, "prove mode needs assignments"
            self.instance_assignment.append(int(value_fn()) % R)
        return (INSTANCE, idx)

    def new_witness_variable(self, value_fn=None) -> Variable:
        idx = self.num_witness_variables
        self.num_witness_variables += 1
        if not self.is_setup:
            assert value_fn is not None, "prove mode needs assignments"
            self.witness_assignment.append(int(value_fn()) % R)
        return (WITNESS, idx)

    def new_lc(self, terms: list) -> Variable:
        self.lc_map.append(list(terms))
        return (SYMBOLIC, len(self.lc_map) - 1)

    def enforce_constraint(self, a: list, b: list, c: list) -> None:
        ai = self.new_lc(a)[1]
        bi = self.new_lc(b)[1]
        ci = self.new_lc(c)[1]
        self.a_rows.append(ai)
        self.b_rows.append(bi)
        self.c_rows.append(ci)

    # ---- finalize ------------------------------------------------------------

    def _eval_lc_terms(self, terms: list) -> int:
        acc = 0
        for coeff, (kind, idx) in terms:
            if kind == ONE:
                val = 1
            elif kind == INSTANCE:
                val = self.instance_assignment[idx]
            elif kind == WITNESS:
                val = self.witness_assignment[idx]
            else:
                raise ValueError("unexpanded symbolic LC in evaluation")
            acc = (acc + coeff * val) % R
        return acc

    def finalize(self) -> None:
        """Expand symbolic LC references (reference `ics.finalize()` reached
        at src/ahp/indexer.rs:165 / src/ahp/prover.rs:225): inlining for the
        Constraints goal, ark-relations 0.3 `outline_lcs` for the Weight
        goal (the mode Marlin uses, src/ahp/indexer.rs:156)."""
        if self.finalized:
            return
        self.finalized = True
        if self.optimization_goal == OptimizationGoal.WEIGHT:
            self._outline_lcs()
        else:
            self._inline_all_lcs()

    def _inline_flat(self, expanded: list, terms: list) -> list:
        flat: list = []
        for coeff, var in terms:
            kind, idx = var
            if kind == SYMBOLIC:
                flat.extend((coeff * c2 % R, v2) for c2, v2 in expanded[idx])
            else:
                flat.append((coeff, var))
        return _merge(flat)

    def _inline_all_lcs(self) -> None:
        """ark-relations `inline_all_lcs` (Constraints goal): substitute every
        symbolic reference in creation order."""
        expanded: list = [None] * len(self.lc_map)
        for i, terms in enumerate(self.lc_map):
            expanded[i] = self._inline_flat(expanded, terms)
        self.lc_map = expanded

    def _outline_lcs(self) -> None:
        """ark-relations 0.3 `outline_lcs` (Weight goal).

        Walk the LC map in creation order (LCs only reference earlier LCs).
        For each LC: substitute already-transformed references, compactify,
        then dedicate a fresh witness iff the nnz cost favors it —

            t * l > t + 2 + l

        where t = (#references from other LCs) + 1 and l = the inlined
        length: `t*l` is the inlined cost at every use site; outlining
        costs one `lc * 1 = w` constraint (l + 2 entries) plus one entry
        per use.  Row LCs have t = 1 and never outline.  Outlined LCs are
        replaced by `1*w` everywhere; the equality constraints are appended
        after the map transformation, in outline order.

        Semantics reconstructed from ark-relations 0.3's cost model and
        pinned by golden counts on the reference's fixture circuits
        (tests/test_r1cs.py) — including OutlineTestCircuit
        (reference src/test.rs:53-114), whose 10-term bucket chains outline
        exactly at inlined length 5.
        """
        n = len(self.lc_map)
        # references from other LCs' terms only (ark lc_num_times_used(false));
        # uses as constraint rows are represented by the row LCs themselves
        num_times_used = [0] * n
        for terms in self.lc_map:
            for _, (kind, idx) in terms:
                if kind == SYMBOLIC:
                    num_times_used[idx] += 1

        transformed: list = [None] * n
        outlined: list = []  # (inlined_terms, witness_var) in outline order
        for i, terms in enumerate(self.lc_map):
            flat = self._inline_flat(transformed, terms)
            t = num_times_used[i] + 1
            l = len(flat)
            if t * l > t + 2 + l:
                idx_w = self.num_witness_variables
                self.num_witness_variables += 1
                if not self.is_setup:
                    self.witness_assignment.append(self._eval_lc_terms(flat))
                w_var = (WITNESS, idx_w)
                outlined.append((flat, w_var))
                flat = [(1, w_var)]
            transformed[i] = flat

        self.lc_map = transformed
        # append the equality constraints: lc * 1 = w
        for flat, w_var in outlined:
            self.lc_map.append(list(flat))
            ai = len(self.lc_map) - 1
            self.lc_map.append([(1, VAR_ONE)])
            bi = len(self.lc_map) - 1
            self.lc_map.append([(1, w_var)])
            ci = len(self.lc_map) - 1
            self.a_rows.append(ai)
            self.b_rows.append(bi)
            self.c_rows.append(ci)

    # ---- matrices ------------------------------------------------------------

    def _col(self, var: Variable) -> int:
        kind, idx = var
        if kind == ONE:
            return 0
        if kind == INSTANCE:
            return idx
        if kind == WITNESS:
            return self.num_instance_variables + idx
        raise ValueError("symbolic variable after finalize")

    def _make_row(self, lc_index: int) -> list:
        row = [(c, self._col(v)) for c, v in self.lc_map[lc_index]]
        return sorted(row, key=lambda t: t[1])

    def to_matrices(self):
        """-> (a, b, c) with rows of (coeff, col), cols ascending."""
        assert self.finalized, "call finalize() first"
        a = [self._make_row(i) for i in self.a_rows]
        b = [self._make_row(i) for i in self.b_rows]
        c = [self._make_row(i) for i in self.c_rows]
        return a, b, c

    def full_assignment(self) -> list:
        return list(self.instance_assignment) + list(self.witness_assignment)

    def is_satisfied(self) -> bool:
        """Debug check: Az ∘ Bz == Cz."""
        a, b, c = self.to_matrices()
        z = self.full_assignment()

        def dot(row):
            return sum(coeff * z[col] for coeff, col in row) % R

        return all(dot(ra) * dot(rb) % R == dot(rc) for ra, rb, rc in zip(a, b, c))
