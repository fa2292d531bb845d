"""Poseidon Merkle membership on the port's constraint system.

The statement: BATCH leaves lie in one binary Merkle tree of depth DEPTH
under one root.  Public: the root, then the leaves (16 instance columns
with the constant one, at the file's sizes).  At each level of a path the
circuit allocates a path bit (constrained boolean), the sibling and one
product for the swap, `m = bit * (sib - cur)`, so `left = cur + m` and
`right = sib - m`; then one Poseidon permutation of `[0, left, right]`
whose output `state[0]` is the next level's `cur`.  The last level's
output equals the root.

Poseidon as Grassi et al. specify it, with circomlib's parameters for two
inputs over BN254's scalar field: t = 3, S-box x^5, R_F = 8 full rounds
(four before the partial ones, four after), R_P = 57 partial rounds, each
round adding its constants, applying the S-boxes and the MDS matrix.  The
round constants and the Cauchy MDS matrix M[i][j] = 1/(x_i + y_j) are
drawn by SHA-256 from a fixed tag, in place of the Grain LFSR; all are
non-zero, so the constraint system has the shape the LFSR's give.  As a
gadget library builds it, every S-box input and every MDS output is a
symbolic linear combination (`new_lc`), which `finalize` inlines or
outlines under the Weight goal.

The witness comes from (a, b) by SHA-256, reduced mod r: BATCH distinct
DEPTH-bit leaf positions, the leaves, and every node off the paths keyed by
(level, index); the nodes on the paths are hashed, so every path meets the
one root.  In setup mode the circuit allocates and constrains only.

Each call of `generate_constraints` appends its (start, end) host clock
readings to `timings`, which the harness reads as synthesis time.
"""

from __future__ import annotations

import hashlib
import time

from marlin_tpu_torch.snark.r1cs import VAR_ONE, lc, lc_add, lc_scale

R_BN254 = 21888242871839275222246405745257275088548364400416034343698204186575808495617
T, ALPHA, R_F, R_P = 3, 5, 8, 57
DEPTH, BATCH = 20, 14
TAG = b"marlin_tpu/poseidon/bn254/t3/x5/rf8/rp57"

SBOXES = T * R_F + R_P  # 81 a permutation
# per level of a path: three products an S-box, the bit's and the swap's
LEVEL_CONSTRAINTS = 3 * SBOXES + 2
# per level: x^2, x^4 and x^5 of each S-box, then bit, sibling and swap product
LEVEL_WITNESSES = 3 * SBOXES + 3
# per level, the symbolic LCs that finalize outlines: every S-box input but
# the first round's lane 0 (the constant c * 1, one term); MDS outputs 1 and
# 2 where the next round's three MDS outputs read them (after the last full
# round of the first half and after every partial round but the last); the
# permutation's output, read three times by the next level's swap (the last
# level's output is read once, by the root's row, and stays symbolic)
LEVEL_OUTLINED = (SBOXES - 1) + 2 * R_P + 1


def sizes(depth: int = DEPTH, batch: int = BATCH) -> tuple:
    """(constraints, variables) after finalize, before the matrices are squared."""
    outlined = batch * (depth * LEVEL_OUTLINED - 1)
    instance = 1 << (batch + 1).bit_length()  # one, root, leaves: padded to a power of two
    return (batch * (depth * LEVEL_CONSTRAINTS + 1) + outlined,
            instance + batch * depth * LEVEL_WITNESSES + outlined)


def _hash_int(*parts) -> int:
    h = hashlib.sha256()
    for p in parts:
        h.update(p if isinstance(p, bytes) else int(p).to_bytes(32, "big"))
    return int.from_bytes(h.digest(), "big")


def _constants(r: int) -> tuple:
    rounds = R_F + R_P
    ark = [[_hash_int(TAG, b"ark", T * i + j) % r for j in range(T)] for i in range(rounds)]
    x = [_hash_int(TAG, b"mds-x", i) % r for i in range(T)]
    y = [_hash_int(TAG, b"mds-y", j) % r for j in range(T)]
    mds = [[pow((xi + yj) % r, -1, r) for yj in y] for xi in x]
    assert all(c for row in ark + mds for c in row), "a zero Poseidon constant"
    return ark, mds


def _is_full(rnd: int) -> bool:
    return not (R_F // 2 <= rnd < R_F // 2 + R_P)


class _Poseidon:
    def __init__(self, r: int):
        self.r = r
        self.ark, self.mds = _constants(r)

    def hash(self, left: int, right: int) -> int:
        r = self.r
        s = [0, left, right]
        for rnd in range(R_F + R_P):
            s = [(v + c) % r for v, c in zip(s, self.ark[rnd])]
            for j in range(T if _is_full(rnd) else 1):
                s[j] = pow(s[j], ALPHA, r)
            s = [(row[0] * s[0] + row[1] * s[1] + row[2] * s[2]) % r for row in self.mds]
        return s[0]

    def gadget(self, cs, state: list, values: list | None) -> tuple:
        """The permutation on three LCs (and their values in prove mode)
        -> (state[0] as an LC, its value or None)."""
        r = self.r
        for rnd in range(R_F + R_P):
            lanes = []
            for j in range(T):
                x = lc_add(state[j], lc((self.ark[rnd][j], VAR_ONE)))
                value = None if values is None else (values[j] + self.ark[rnd][j]) % r
                if j == 0 or _is_full(rnd):
                    x, value = self._sbox(cs, lc(cs.new_lc(x)), value)
                lanes.append((x, value))
            state = [lc(cs.new_lc(lc_add(lc_add(lc_scale(lanes[0][0], row[0]), lc_scale(lanes[1][0], row[1])),
                                         lc_scale(lanes[2][0], row[2]))))
                     for row in self.mds]
            if values is not None:
                values = [sum(m * v for m, (_, v) in zip(row, lanes)) % r for row in self.mds]
        return state[0], None if values is None else values[0]

    def _sbox(self, cs, v: list, value: int | None) -> tuple:
        """x^5 in three products, x2 = v*v, x4 = x2*x2, x5 = x4*v -> (x5 as an LC, its value)."""
        r = self.r
        x2v = x4v = x5v = None
        if value is not None:
            x2v = value * value % r
            x4v = x2v * x2v % r
            x5v = x4v * value % r
        x2, x4, x5 = _witness(cs, x2v), _witness(cs, x4v), _witness(cs, x5v)
        cs.enforce_constraint(v, v, lc(x2))
        cs.enforce_constraint(lc(x2), lc(x2), lc(x4))
        cs.enforce_constraint(lc(x4), v, lc(x5))
        return lc(x5), x5v


def _witness(cs, value):
    return cs.new_witness_variable(None if value is None else (lambda: value))


class Circuit:
    def __init__(self, r: int, a: int, b: int, num_constraints: int, num_variables: int,
                 timings: list | None = None, depth: int = DEPTH, batch: int = BATCH):
        if r != R_BN254:
            raise ValueError("the Poseidon parameters are BN254's: the circuit is over its scalar field")
        if batch > 1 << depth:
            raise ValueError(f"a tree of depth {depth} has fewer than {batch} leaves")
        if (num_constraints, num_variables) != sizes(depth, batch):
            raise ValueError(f"depth {depth} and batch {batch} synthesize {sizes(depth, batch)} "
                             f"constraints and variables, not {(num_constraints, num_variables)}")
        self.r = r
        self.a, self.b = a, b
        self.depth, self.batch = depth, batch
        self.timings = timings if timings is not None else []

    def _draw(self, label: bytes, *ints) -> int:
        return _hash_int(self.a, self.b, label, *ints)

    def tree(self, poseidon: _Poseidon) -> tuple:
        """(positions, leaves, {(level, index): node}) with every node on a
        path and every sibling of one."""
        mask = (1 << self.depth) - 1
        positions: list = []
        k = 0
        while len(positions) < self.batch:
            p = self._draw(b"position", k) & mask
            k += 1
            if p not in positions:
                positions.append(p)
        leaves = [self._draw(b"leaf", i) % self.r for i in range(self.batch)]
        nodes = dict(zip(((0, p) for p in positions), leaves))
        level_nodes = sorted(set(positions))
        for level in range(self.depth):
            for idx in level_nodes:
                nodes.setdefault((level, idx ^ 1), self._draw(b"node", level, idx ^ 1) % self.r)
            level_nodes = sorted({idx >> 1 for idx in level_nodes})
            for idx in level_nodes:
                nodes[(level + 1, idx)] = poseidon.hash(nodes[(level, 2 * idx)], nodes[(level, 2 * idx + 1)])
        return positions, leaves, nodes

    def generate_constraints(self, cs) -> None:
        start = time.perf_counter()
        poseidon = _Poseidon(self.r)
        prove = not cs.is_setup
        if prove:
            positions, leaves, nodes = self.tree(poseidon)
            root_value = nodes[(self.depth, 0)]
        else:
            positions, leaves, nodes, root_value = [None] * self.batch, [None] * self.batch, None, None
        root = cs.new_input_variable(None if root_value is None else (lambda: root_value))
        leaf_vars = [cs.new_input_variable(None if v is None else (lambda v=v: v)) for v in leaves]
        for pos, leaf, leaf_var in zip(positions, leaves, leaf_vars):
            cur, value = lc(leaf_var), leaf
            for level in range(self.depth):
                if prove:
                    bit = (pos >> level) & 1
                    sib_value = nodes[(level, (pos >> level) ^ 1)]
                    m_value = bit * (sib_value - value) % self.r
                    left_value, right_value = (value + m_value) % self.r, (sib_value - m_value) % self.r
                bit_var = _witness(cs, bit if prove else None)
                sib = _witness(cs, sib_value if prove else None)
                m = _witness(cs, m_value if prove else None)
                cs.enforce_constraint(lc(bit_var), lc(VAR_ONE, (-1, bit_var)), lc())
                cs.enforce_constraint(lc(bit_var), lc_add(lc(sib), lc_scale(cur, -1)), lc(m))
                state = [lc(), lc_add(cur, lc(m)), lc(sib, (-1, m))]
                cur, value = poseidon.gadget(cs, state, [0, left_value, right_value] if prove else None)
                if prove and value != nodes[(level + 1, pos >> (level + 1))]:
                    raise AssertionError("the gadget's hash differs from the tree's")
            cs.enforce_constraint(cur, lc(VAR_ONE), lc(root))
        self.timings.append((start, time.perf_counter()))
