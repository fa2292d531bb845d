"""Poseidon Merkle membership, written out by the reference in plain ints.

The statement: BATCH leaves lie in one binary Merkle tree of depth DEPTH
under one root.  The root and the leaves are public, in that order.  Each
level of a path has a path bit (boolean-constrained), a sibling and one
product for the swap, `left = cur + bit*(sib - cur)`, `right = sib -
(left - cur)`, then one Poseidon permutation of `[0, left, right]` whose
output is `state[0]`: x^5 S-boxes, t = 3, R_F = 8 full rounds (four
before and four after) and R_P = 57 partial ones, over BN254's scalar
field (circomlib's poseidon.circom parameters for two inputs).  The round
constants and the dense Cauchy MDS matrix are drawn by SHA-256 from a
fixed tag in place of the Grain LFSR: every constant is non-zero, so the
R1CS has the shape the LFSR's constants give.

`matrices` builds the constraint system the way a gadget library does
(every S-box input and every MDS output a symbolic linear combination),
then does what a constraint system does before Marlin indexes it: pads the
input to a power of two, resolves the symbolic combinations under
ark-relations 0.3's Weight goal (outline an LC into a new witness `w` and a
row `lc * 1 = w` iff `t*l > t + 2 + l`, with t its uses in other LCs plus
one and l its length once its own references are resolved), and squares
the matrices.  `public_input` builds the tree from the witness derivation
with its own native Poseidon.
"""

from __future__ import annotations

import hashlib

R = 21888242871839275222246405745257275088548364400416034343698204186575808495617  # BN254 Fr
T, R_F, R_P = 3, 8, 57
DEPTH, BATCH = 20, 14
TAG = b"marlin_tpu/poseidon/bn254/t3/x5/rf8/rp57"


def _digest(*parts) -> int:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else int(p).to_bytes(32, "big"))
    return int.from_bytes(h.digest(), "big")


def parameters() -> tuple:
    """(round constants [R_F + R_P][T], MDS [T][T]): M[i][j] = 1 / (x_i + y_j)."""
    ark = [[_digest(TAG, b"ark", rnd * T + j) % R for j in range(T)] for rnd in range(R_F + R_P)]
    xs = [_digest(TAG, b"mds-x", i) % R for i in range(T)]
    ys = [_digest(TAG, b"mds-y", j) % R for j in range(T)]
    if len(set(xs)) != T or len(set(ys)) != T or any((x + y) % R == 0 for x in xs for y in ys):
        raise ValueError("the tag gives no Cauchy matrix")
    mds = [[pow(x + y, -1, R) for y in ys] for x in xs]
    if any(c == 0 for row in ark for c in row) or any(c == 0 for row in mds for c in row):
        raise ValueError("a zero constant")
    return ark, mds


def full_round(rnd: int) -> bool:
    return rnd < R_F // 2 or rnd >= R_F // 2 + R_P


def poseidon(left: int, right: int) -> int:
    """The permutation of [0, left, right], its state[0]."""
    ark, mds = parameters()
    s = [0, left % R, right % R]
    for rnd in range(R_F + R_P):
        s = [(v + c) % R for v, c in zip(s, ark[rnd])]
        s = [pow(v, 5, R) if (j == 0 or full_round(rnd)) else v for j, v in enumerate(s)]
        s = [sum(m * v for m, v in zip(row, s)) % R for row in mds]
    return s[0]


# ---- the witness, from (a, b) -----------------------------------------------


def _draw(a: int, b: int, label: bytes, *ints) -> int:
    return _digest(a, b, label, *ints)


def positions(a: int, b: int, depth: int, batch: int) -> list:
    """`batch` distinct leaf positions of `depth` bits, in the order drawn."""
    if batch > 1 << depth:
        raise ValueError("more leaves than the tree holds")
    out: list = []
    k = 0
    while len(out) < batch:
        p = _draw(a, b, b"position", k) & ((1 << depth) - 1)
        if p not in out:
            out.append(p)
        k += 1
    return out


def tree(a: int, b: int, depth: int, batch: int) -> tuple:
    """-> (positions, leaves, nodes {(level, index): value}) with every node
    on the paths and every sibling of one; the root is nodes[(depth, 0)]."""
    pos = positions(a, b, depth, batch)
    leaves = [_draw(a, b, b"leaf", i) % R for i in range(batch)]
    nodes = {(0, p): leaf for p, leaf in zip(pos, leaves)}
    on_path = set(pos)
    for level in range(depth):
        for idx in sorted(on_path):
            sib = idx ^ 1
            if (level, sib) not in nodes:
                nodes[(level, sib)] = _draw(a, b, b"node", level, sib) % R
        parents = set()
        for idx in sorted(on_path):
            even = idx & ~1
            nodes[(level + 1, idx >> 1)] = poseidon(nodes[(level, even)], nodes[(level, even + 1)])
            parents.add(idx >> 1)
        on_path = parents
    return pos, leaves, nodes


def public_input(r: int, a: int, b: int, depth: int = DEPTH, batch: int = BATCH) -> list:
    """[root, leaf_1, ...], with the zero inputs that pad it, with the
    constant one, to a power of two (none at the file's sizes)."""
    if r != R:
        raise ValueError("the circuit is over BN254's scalar field")
    _, leaves, nodes = tree(a, b, depth, batch)
    padding = (1 << (batch + 1).bit_length()) - 2 - batch
    return [nodes[(depth, 0)]] + leaves + [0] * padding


# ---- the R1CS -----------------------------------------------------------------
# An LC is a dict {variable: coefficient}; a variable is ("one",), ("in", i),
# ("w", i) or ("lc", i), the last a reference to the i-th symbolic LC.

ONE = ("one",)


def _lin(*pairs) -> dict:
    out: dict = {}
    for c, v in pairs:
        out[v] = (out.get(v, 0) + c) % R
    return {v: c for v, c in out.items() if c}


def _sum(*scaled) -> dict:
    """sum of s * lc over (s, lc) pairs."""
    return _lin(*((s * c, v) for s, lc in scaled for v, c in lc.items()))


class _System:
    def __init__(self):
        self.num_inputs = 1
        self.num_witnesses = 0
        self.lcs: list = []
        self.rows: list = []  # (a, b, c) as LC numbers

    def input(self) -> tuple:
        self.num_inputs += 1
        return ("in", self.num_inputs - 1)

    def witness(self) -> tuple:
        self.num_witnesses += 1
        return ("w", self.num_witnesses - 1)

    def symbolic(self, lc: dict) -> tuple:
        self.lcs.append(lc)
        return ("lc", len(self.lcs) - 1)

    def enforce(self, a: dict, b: dict, c: dict) -> None:
        self.rows.append(tuple(self.symbolic(x)[1] for x in (a, b, c)))


def _synthesize(depth: int, batch: int) -> _System:
    ark, mds = parameters()
    cs = _System()
    root = cs.input()
    leaves = [cs.input() for _ in range(batch)]
    for leaf in leaves:
        cur = _lin((1, leaf))
        for _ in range(depth):
            bit, sib, m = cs.witness(), cs.witness(), cs.witness()
            cs.enforce(_lin((1, bit)), _lin((1, ONE), (-1, bit)), {})
            cs.enforce(_lin((1, bit)), _sum((1, _lin((1, sib))), (-1, cur)), _lin((1, m)))
            state = [{}, _sum((1, cur), (1, _lin((1, m)))), _lin((1, sib), (-1, m))]
            for rnd in range(R_F + R_P):
                after = []
                for j in range(T):
                    x = _sum((1, state[j]), (ark[rnd][j], {ONE: 1}))
                    if j == 0 or full_round(rnd):
                        v = _lin((1, cs.symbolic(x)))
                        x2, x4, x5 = cs.witness(), cs.witness(), cs.witness()
                        cs.enforce(v, v, _lin((1, x2)))
                        cs.enforce(_lin((1, x2)), _lin((1, x2)), _lin((1, x4)))
                        cs.enforce(_lin((1, x4)), v, _lin((1, x5)))
                        x = _lin((1, x5))
                    after.append(x)
                state = [_lin((1, cs.symbolic(_sum(*zip(row, after))))) for row in mds]
            cur = state[0]
        cs.enforce(cur, {ONE: 1}, _lin((1, root)))
    return cs


def outline(cs: _System) -> int:
    """Resolve every symbolic LC in creation order under the Weight goal;
    append the rows of the outlined ones.  -> how many were outlined."""
    uses = [0] * len(cs.lcs)
    for lc in cs.lcs:
        for v in lc:
            if v[0] == "lc":
                uses[v[1]] += 1
    resolved: list = []
    outlined: list = []
    for i, lc in enumerate(cs.lcs):
        flat: dict = {}
        for v, c in lc.items():
            for v2, c2 in (resolved[v[1]].items() if v[0] == "lc" else ((v, 1),)):
                flat[v2] = (flat.get(v2, 0) + c * c2) % R
        flat = {v: c for v, c in flat.items() if c}
        t, n = uses[i] + 1, len(flat)
        if t * n > t + 2 + n:
            w = cs.witness()
            outlined.append((flat, w))
            flat = {w: 1}
        resolved.append(flat)
    cs.lcs = resolved
    for flat, w in outlined:
        cs.enforce(flat, {ONE: 1}, {w: 1})
    return len(outlined)


def matrices(num_constraints: int, num_variables: int, depth: int = DEPTH, batch: int = BATCH) -> tuple:
    """-> (num_instance, a, b, c): rows of (coefficient, column), the matrices
    square.  Raises unless (num_constraints, num_variables) are the counts
    of the resolved system before it is squared."""
    cs = _synthesize(depth, batch)
    num_instance = 1 << (cs.num_inputs - 1).bit_length()  # the input padded with zeros
    outline(cs)
    got = (len(cs.rows), num_instance + cs.num_witnesses)
    if got != (num_constraints, num_variables):
        raise ValueError(f"the circuit resolves to {got}, the configuration states "
                         f"{(num_constraints, num_variables)}")

    def column(v) -> int:
        return 0 if v == ONE else v[1] if v[0] == "in" else num_instance + v[1]

    mats = [[sorted(((c, column(v)) for v, c in cs.lcs[row[k]].items()), key=lambda t: t[1])
             for row in cs.rows] for k in range(3)]
    size = max(got)
    for m in mats:
        m.extend([] for _ in range(size - len(m)))  # 0 * 0 = 0 rows; extra witnesses appear nowhere
    return (num_instance, *mats)
