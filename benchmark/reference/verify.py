"""Marlin's verifier, in plain Python ints, with the setup's trapdoor in
place of the pairings.

It decodes a proof from its bytes (arkworks' compressed layout), replays
the Fiat-Shamir transcript (arkworks marlin src/lib.rs:315-433), builds the
AHP's two sumcheck equations (src/ahp/mod.rs:110-221) from the proof's
evaluations, and checks every query point's batched opening.  A pairing
check e(A, h) = e(W, tau h) holds exactly when A = tau W in G1, so knowing
tau (and gamma, the hiding base's logarithm) the checks become equalities of
G1 points, made once for each query point and without the verifier's random
batching coefficient:

* MarlinKZG10 (ark-poly-commit marlin_pc): for each label at the point,
  chi * (its commitment - v g), and for a degree-bounded label also the next
  power of the opening challenge times (its shifted commitment -
  v tau^(D-b) g); minus random_v gamma g; this sum equals (tau - z) W.
* Sonic (ark-poly-commit sonic_pc): a bounded label's commitment is to
  x^(D-b) p, so its term is scaled by tau^-(D-b); one power of the challenge
  a label.

`check` returns the list of what failed (empty when the proof verifies):
a malformed encoding, an opening at beta with no blinding value (the
configuration states hiding commitments for w, z_a, z_b and g_1), a query
point whose equality fails.
"""

from __future__ import annotations

from .curves import G1, Curve
from .index import IndexInfo, domain_gen, domain_size
from .transcript import Transcript, fr_bytes

PROTOCOL = b"MARLIN-2019"
PROVER_LABELS = ("w", "z_a", "z_b", "mask_poly", "t", "g_1", "h_1", "g_2", "h_2")
ROUND_SIZES = (4, 3, 2)
ZERO_EVAL = ("inner_sumcheck", "outer_sumcheck")


class Malformed(ValueError):
    pass


def _reader(data: bytes):
    off = 0

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(data):
            raise Malformed("truncated proof")
        chunk = data[off:off + n]
        off += n
        return chunk

    def done() -> bool:
        return off == len(data)

    return take, done


def decode(g1: G1, data: bytes) -> dict:
    """Proof bytes -> {'comms': [[(comm, shifted)]], 'evals', 'openings': [(w, random_v)]}."""
    take, done = _reader(data)
    c = g1.c
    u64 = lambda: int.from_bytes(take(8), "little")

    def flag() -> int:
        f = take(1)[0]
        if f > 1:
            raise Malformed("bad option flag")
        return f

    def point():
        try:
            return g1.decompress(take(c.fq_bytes))
        except ValueError as e:
            raise Malformed(str(e)) from None

    def fr() -> int:
        v = int.from_bytes(take(32), "little")
        if v >= c.r:
            raise Malformed("scalar out of range")
        return v

    n_rounds = u64()
    if n_rounds != 3:
        raise Malformed(f"{n_rounds} rounds")
    comms = []
    for size in ROUND_SIZES:
        if u64() != size:
            raise Malformed("round size")
        row = []
        for _ in range(size):
            comm = point()
            row.append((comm, point() if flag() else None))
        comms.append(row)
    n_evals = u64()
    if n_evals > 64:
        raise Malformed("evaluation count")
    evals = [fr() for _ in range(n_evals)]
    if u64() != 3 or any(flag() for _ in range(3)):
        raise Malformed("prover messages")
    n_open = u64()
    if n_open != 2:
        raise Malformed(f"{n_open} openings")
    openings = []
    for _ in range(n_open):
        w = point()
        openings.append((w, fr() if flag() else None))
    if flag() or not done():
        raise Malformed("trailing data")
    return {"comms": comms, "evals": evals, "openings": openings}


def _comm_bytes(g1: G1, comm, shifted) -> bytes:
    out = g1.to_bytes(comm)
    return out + (b"\x00" if shifted is None else b"\x01" + g1.to_bytes(shifted))


def _outside(curve: Curve, fs: Transcript, size: int) -> int:
    while True:
        t = fs.rand_fr()
        if (pow(t, size, curve.r) - 1) % curve.r:
            return t


def check(curve: Curve, scheme: str, info: IndexInfo, index_comms: list, max_degree: int,
          trapdoor: tuple, public_input: list, proof: bytes) -> list:
    """The failures of one proof of `public_input` (empty: it verifies)."""
    r = curve.r
    g1 = G1(curve)
    tau, gamma = trapdoor
    try:
        p = decode(g1, proof)
    except Malformed as e:
        return [f"malformed: {e}"]
    bounded_at = {"g_1": (1, 1), "g_2": (2, 0)}
    for label, (rnd, i) in bounded_at.items():
        has_shift = p["comms"][rnd][i][1] is not None
        if has_shift != (scheme == "marlin"):
            return [f"{label}: shifted commitment {'missing' if scheme == 'marlin' else 'present'}"]
    for rnd, row in enumerate(p["comms"]):
        for i, (_, shifted) in enumerate(row):
            if shifted is not None and (rnd, i) not in bounded_at.values():
                return ["a shifted commitment on an unbounded polynomial"]
    # w, z_a, z_b and g_1 are hiding (ZK bound 1), all opened at beta; the
    # polynomials opened at gamma are not, and their opening has no random_v
    (_, rv_beta), (_, rv_gamma) = p["openings"]
    failures = [] if rv_beta else ["opening at beta: no blinding"]
    if rv_gamma is not None:
        failures.append("opening at gamma: a blinding value where nothing hides")

    h = domain_size(curve, info.num_constraints)
    k = domain_size(curve, info.num_non_zero)
    formatted = [1] + [v % r for v in public_input]
    x = domain_size(curve, len(formatted))
    if x != len(formatted):
        return ["public input length"]
    initial = PROTOCOL + info.to_bytes() + b"".join(_comm_bytes(g1, cm, None) for cm in index_comms)
    fs = Transcript(curve, initial + b"".join(fr_bytes(v) for v in formatted[1:]))
    fs.absorb(b"".join(_comm_bytes(g1, *cm) for cm in p["comms"][0]))
    alpha = _outside(curve, fs, h)
    eta_a, eta_b, eta_c = fs.rand_fr(), fs.rand_fr(), fs.rand_fr()
    fs.absorb(b"".join(_comm_bytes(g1, *cm) for cm in p["comms"][1]))
    beta = _outside(curve, fs, h)
    fs.absorb(b"".join(_comm_bytes(g1, *cm) for cm in p["comms"][2]))
    gamma_q = fs.rand_fr()
    if len(p["evals"]) != 4:
        return failures + [f"{len(p['evals'])} evaluations"]
    fs.absorb(b"".join(fr_bytes(v) for v in p["evals"]))
    eps = fs.rand_u128() % r
    # evaluations in label order: g_1(beta), g_2(gamma), t(beta), z_b(beta)
    g1_b, g2_g, t_b, zb_b = p["evals"]

    # the outer and inner sumcheck combinations
    vh = lambda v: (pow(v, h, r) - 1) % r
    r_ab = (vh(alpha) - vh(beta)) * pow((alpha - beta) % r, -1, r) % r if alpha != beta \
        else h * pow(alpha, h - 1, r) % r
    v_x_beta = (pow(beta, x, r) - 1) % r
    w_x = domain_gen(curve, x)
    x_beta = 0
    e = 1
    for v in formatted:  # L_i(beta) over X
        x_beta += v * (v_x_beta * pow(x, -1, r) % r) * e % r * pow((beta - e) % r, -1, r)
        e = e * w_x % r
    x_beta %= r
    outer = [(1, "mask_poly"), (r_ab * (eta_a + eta_c * zb_b) % r, "z_a"),
             (r_ab * eta_b % r * zb_b % r, None), ((-t_b * v_x_beta) % r, "w"),
             ((-t_b * x_beta) % r, None), ((-vh(beta)) % r, "h_1"), ((-beta * g1_b) % r, None)]
    s_a = vh(alpha) * vh(beta) % r
    s_b = (gamma_q * g2_g + t_b * pow(k, -1, r)) % r
    inner = [(eta_a * s_a % r, "a_val"), (eta_b * s_a % r, "b_val"), (eta_c * s_a % r, "c_val"),
             ((-beta * alpha % r * s_b) % r, None), (alpha * s_b % r, "row"), (beta * s_b % r, "col"),
             ((-s_b) % r, "row_col"), ((-pow(gamma_q, k, r) + 1) % r, "h_2")]
    lcs = {"g_1": [(1, "g_1")], "outer_sumcheck": outer, "t": [(1, "t")], "z_b": [(1, "z_b")],
           "g_2": [(1, "g_2")], "inner_sumcheck": inner}
    values = {"g_1": g1_b, "outer_sumcheck": 0, "t": t_b, "z_b": zb_b, "g_2": g2_g, "inner_sumcheck": 0}
    comm_of = dict(zip(("row", "col", "a_val", "b_val", "c_val", "row_col"), ((cm, None) for cm in index_comms)))
    comm_of.update(zip(PROVER_LABELS, (cm for row in p["comms"] for cm in row)))
    bound_of = {"g_1": h - 2, "g_2": k - 2}

    groups = [(beta, ["g_1", "outer_sumcheck", "t", "z_b"]), (gamma_q, ["g_2", "inner_sumcheck"])]
    for (z, labels), (w, rv) in zip(groups, p["openings"]):
        pairs = []  # (scalar, point)
        s_g = 0  # the scalar of g
        chi = 1
        for label in labels:
            terms = lcs[label]
            v = values[label]
            bound = next((bound_of[t] for _, t in terms if t in bound_of), None)
            if scheme == "sonic" and bound is not None:
                unshift = pow(pow(tau, max_degree - bound, r), -1, r)
            else:
                unshift = 1
            for cf, t in terms:
                if t is None:
                    s_g += chi * cf * unshift
                else:
                    pairs.append((chi * cf % r * unshift % r, comm_of[t][0]))
            s_g -= chi * v
            chi = chi * eps % r
            if scheme == "marlin" and bound is not None:
                (cf, t), = terms
                pairs.append((chi * cf % r, comm_of[t][1]))
                s_g -= chi * v * pow(tau, max_degree - bound, r)
                chi = chi * eps % r
        s_g -= (rv or 0) * gamma
        pairs.append((s_g % r, curve.gen))
        pairs.append(((z - tau) % r, w))
        if g1.msm(pairs) is not None:
            failures.append(f"opening at {'beta' if z == beta else 'gamma'}: the equality fails")
    return failures
